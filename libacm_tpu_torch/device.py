"""Where the port's entry points run: the card, unless the caller asks.

Every entry point that takes `device=None` resolves it here, at the call
(never at import): the device named by LIBACM_TPU_TORCH_DEVICE when that
is set (for example `cpu`), else the card. No card is an error, never a
quiet fall back to the CPU.
"""

from __future__ import annotations

import os
from typing import Union

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
