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
`unpack_blocks`, which launches the kernel or raises. A call with a word
to write is one launch and no other device operation: stamp tickets
resolve which packed row owns each block, output tickets write every word
of k once, from its owner row or as zero (`plan` says how it is cut). The
owner words and counters live in a scratch buffer kept per device and
stream (`_Scratch`): each call takes a new epoch, so they need no reset.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from . import synth_cuda, unpack_cuda
from .kernels import Launches

_SRC = (pathlib.Path(__file__).resolve().parent.parent / "csrc"
        / "unpack_blocks.cu")

#: the kernel's constants (csrc/unpack_blocks.cu): threads a CTA; words
#: an output ticket writes (a pass); the owner word's epoch shift; the
#: scratch words of the stamp count and of the first owner word (the
#: ticket counter is word 0); the most blocks a pass may span and still
#: read their owner words once into shared memory
THREADS = 256
PASS = 8192
EPOCH_SHIFT = 40
DONE = 16
OWNERS = 32
OWN_CACHE = 64
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
                vp, vp, vp, vp, vp, vp,  # p4, p8, p16, idx4, idx8, idx16
                vp, vp,  # out, scratch
                ll, ll, ll, ll, ll,  # n4, n8, n16, nb, n
                ll, ll,  # nstamp, grid
                ll, ll, ll, vp,  # epoch, ticket0, done0, stream
            ]
            _lib = lib
    return _lib


def plan(n4: int, n8: int, n16: int, n: int, nb: int) -> dict:
    """The launch of one call: `nstamp` stamp CTAs (THREADS packed rows
    each, the three classes' rows numbered in turn: 4-bit, 8-bit, 16-bit),
    then `units` output CTAs of PASS words of the flat [nb * n] output
    each; `grid` = both, 0 where there is no word to write."""
    total = nb * n if nb > 0 and n > 0 else 0
    rows = n4 + n8 + n16
    nstamp = -(-rows // THREADS) if total else 0
    units = -(-total // PASS)
    return {"nstamp": nstamp, "units": units, "grid": nstamp + units,
            "total": total, "rows": rows}


class _Scratch(unpack_cuda._Scratch):
    """The kernel's scratch, one buffer per (device, stream), zeroed once
    when made (unpack_cuda's, with buffers of its own): word 0 the ticket
    counter, word DONE the count of stamp CTAs done, and from word OWNERS
    on an owner word a block. Each call takes the next epoch, the tickets and the stamp CTAs
    counted so far, so stale owner words of earlier calls read as
    unnamed."""

    _by_key: dict = {}

    def __init__(self, dev: torch.device, words: int):
        super().__init__(dev, words)
        self.done = 0

    @classmethod
    def take(cls, dev: torch.device, stream: int, words: int):
        s = super().take(dev, stream, words)
        if s.epoch == 1:  # a new buffer, or one zeroed at the wrap
            s.done = 0
        return s


def unpack_blocks(
    p4: torch.Tensor, p8: torch.Tensor, p16: torch.Tensor,
    idx4: torch.Tensor, idx8: torch.Tensor, idx16: torch.Tensor,
    *, nb: int, rows: int, cols: int,
) -> torch.Tensor:
    """int16 [nb, rows, cols] from the packed classes on one card,
    bit-identical to ops.packing.unpack_blocks_plain for every int32 idx
    (the JAX package's index rules; rows of one class naming one block
    are outside the contract)."""
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
    out = torch.empty((nb, rows, cols), dtype=torch.int16, device=dev)
    n4, n8, n16 = idx4.shape[0], idx8.shape[0], idx16.shape[0]
    p = plan(n4, n8, n16, n, nb)
    if not p["grid"]:
        return out
    if p["grid"] > _MAX_GRID_X or p["rows"] >= 1 << 31:
        raise ValueError(f"{p['grid']} CTAs, {p['rows']} packed rows: too "
                         "many for one launch")
    lib = _load()
    with torch.cuda.device(dev), _Scratch._lock:
        stream = torch.cuda.current_stream(dev).cuda_stream
        s = _Scratch.take(dev, stream, OWNERS + nb)
        rc = lib.acm_unpack_blocks(
            p4.data_ptr(), p8.data_ptr(), p16.data_ptr(), idx4.data_ptr(),
            idx8.data_ptr(), idx16.data_ptr(), out.data_ptr(),
            s.words.data_ptr(), n4, n8, n16, nb, n, p["nstamp"],
            p["grid"], s.epoch, s.tickets % (1 << 32), s.done % (1 << 32),
            stream)
        s.tickets += p["grid"]
        s.done += p["nstamp"]
    if rc:
        raise RuntimeError(f"unpack_blocks_kernel launch failed: "
                           f"cudaError {rc}")
    launches.count("unpack_blocks")
    return out
