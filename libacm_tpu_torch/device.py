"""Where the port's entry points run: the card, unless the caller asks.

Every entry point that takes `device=None` resolves it here, at the call
(never at import): the device named by LIBACM_TPU_TORCH_DEVICE when that
is set (for example `cpu`), else the card. No card is an error, never a
quiet fall back to the CPU.
"""

from __future__ import annotations

import os
from typing import Sequence, Union

import torch

#: environment variable naming the device of entry points given device=None
DEVICE_ENV = "LIBACM_TPU_TORCH_DEVICE"

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The target device: `device`, else $LIBACM_TPU_TORCH_DEVICE, else
    the card. Raises RuntimeError for a card where CUDA is unavailable."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "decode on the card requested but CUDA is not available; pass "
            f"device='cpu' or set {DEVICE_ENV}=cpu to decode on the CPU")
    return dev


def resolve_devices(
        devices: Union[Device, Sequence[Device]] = None) -> list[torch.device]:
    """A device list from None (the one device of resolve_device), one
    device, or a sequence of devices; strings are allowed and a device may
    repeat (`["cpu"] * 4` and `["cuda:0", "cuda:0"]` are four and two
    shards on one device). Raises RuntimeError where a CUDA device is
    named and no card is there, ValueError for an empty sequence."""
    if devices is None or isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("empty device list")
    return out


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The device list entry points take as `devices=`: every card, or the
    first `n_devices` of them.

    Counterpart of the JAX package's make_mesh. Torch has no mesh: the
    list of devices is the mesh, and an axis name is not carried over
    (decode_corpus_device shards files over the list, decode_stream_device
    blocks). When $LIBACM_TPU_TORCH_DEVICE names a device that is not a
    card, the list is that device `n_devices` times (once for None).
    """
    base = resolve_device(None)
    if base.type != "cuda":
        return [base] * (1 if n_devices is None else n_devices)
    count = torch.cuda.device_count()
    if n_devices is None:
        n_devices = count
    if not 1 <= n_devices <= count:
        raise ValueError(f"need {n_devices} cards, have {count}")
    return [torch.device("cuda", i) for i in range(n_devices)]
