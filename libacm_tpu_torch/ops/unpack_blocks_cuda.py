"""CUDA width-class block unpack for Hopper: build, ctypes binding and
launch.

Replaces the device work that the JAX package compiles with XLA for
`libacm_tpu/ops/packing.py::unpack_blocks` (no Pallas kernel): the nibble
expansion and the three scatters of the dense route's packed
coefficients. The source is `csrc/unpack_blocks.cu`, compiled with nvcc
for sm_90a at first use into `synth_cuda.build_dir()` (its own hash-keyed
shared object) and bound with ctypes through a plain C interface.

`ops.packing.unpack_blocks` dispatches by device: CPU tensors take
`packing.unpack_blocks_plain`, CUDA tensors this module's
`unpack_blocks`, which launches the kernel or raises. A call is one fill
of the output with zeros (the blocks no list names) and, where there is a
packed row and a word a block, one launch (`plan` says how it is cut).
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from . import synth_cuda
from .kernels import Launches

_SRC = (pathlib.Path(__file__).resolve().parent.parent / "csrc"
        / "unpack_blocks.cu")

#: threads a CTA (csrc/unpack_blocks.cu), and the words of a packed row
#: one CTA writes (a multiple of 8; passed to the kernel)
THREADS = 256
CHUNK = 8192
_MAX_GRID_X = (1 << 31) - 1

#: launches per kernel since the last reset_launches()
launches = Launches("unpack_blocks")
reset_launches = launches.reset

_lib = None
_LOCK = threading.Lock()


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/unpack_blocks.cu for sm_90a into synth_cuda.build_dir()
    (cached by source hash): (shared object, nvcc's -Xptxas -v report,
    empty when it was already built)."""
    return synth_cuda.compile_source(_SRC, "unpack_blocks")


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            lib.acm_unpack_blocks.restype = ctypes.c_int
            lib.acm_unpack_blocks.argtypes = [
                vp, vp, vp, vp, vp, vp, vp,  # p4, p8, p16, idx4/8/16, out
                ll, ll, ll, ll,  # n4, n8, nb, n
                ll, ll, ll, vp,  # chunk, splits, grid, stream
            ]
            _lib = lib
    return _lib


def plan(n4: int, n8: int, n16: int, n: int, nb: int) -> tuple[int, int]:
    """(parts a packed row, CTAs): packed rows of the three classes in
    turn (4-bit, 8-bit, 16-bit), each cut into ceil(n / CHUNK) parts of
    CHUNK words, one CTA a part; (0, 0) where there is nothing to write
    (no packed row, no word a block, or no block)."""
    splits = -(-n // CHUNK) if n > 0 and nb > 0 else 0
    return splits, (n4 + n8 + n16) * splits


def unpack_blocks(
    p4: torch.Tensor, p8: torch.Tensor, p16: torch.Tensor,
    idx4: torch.Tensor, idx8: torch.Tensor, idx16: torch.Tensor,
    *, nb: int, rows: int, cols: int,
) -> torch.Tensor:
    """int16 [nb, rows, cols] from the packed classes on one card,
    bit-identical to ops.packing.unpack_blocks_plain where every idx is in
    [0, nb] (an idx outside [0, nb) writes nothing here)."""
    dev = p16.device
    if dev.type != "cuda":
        raise ValueError(f"no unpack_blocks kernel for device {dev}")
    if nb < 0 or rows < 0 or cols < 0:
        raise ValueError(f"bad geometry nb={nb} rows={rows} cols={cols}")
    n = rows * cols
    want = {"p4": (torch.int8, (idx4.shape[0], (n + 1) // 2)),
            "p8": (torch.int8, (idx8.shape[0], n)),
            "p16": (torch.int16, (idx16.shape[0], n))}
    named = {"p4": p4, "p8": p8, "p16": p16, "idx4": idx4, "idx8": idx8,
             "idx16": idx16}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, p16 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name.startswith("idx"):
            if t.dtype != torch.int32 or t.dim() != 1:
                raise ValueError(f"{name} must be int32 [rows], got "
                                 f"{t.dtype} {tuple(t.shape)}")
        elif (t.dtype, tuple(t.shape)) != want[name]:
            raise ValueError(f"{name} must be {want[name][0]} of shape "
                             f"{want[name][1]}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    out = torch.zeros((nb, rows, cols), dtype=torch.int16, device=dev)
    n4, n8, n16 = idx4.shape[0], idx8.shape[0], idx16.shape[0]
    splits, grid = plan(n4, n8, n16, n, nb)
    if not grid:
        return out
    if grid > _MAX_GRID_X:
        raise ValueError(f"{grid} CTAs: too many for one launch")
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.acm_unpack_blocks(
            p4.data_ptr(), p8.data_ptr(), p16.data_ptr(), idx4.data_ptr(),
            idx8.data_ptr(), idx16.data_ptr(), out.data_ptr(), n4, n8, nb,
            n, CHUNK, splits, grid, stream)
    if rc:
        raise RuntimeError(f"unpack_blocks_kernel launch failed: "
                           f"cudaError {rc}")
    launches.count("unpack_blocks")
    return out
