"""CUDA cols-wire unpack for Hopper: build, ctypes binding and dispatch.

Replaces the device work that the JAX package compiles with XLA beside its
synthesis kernel (no Pallas kernel): `libacm_tpu/ops/packing.py::
unpack_columns`, the class-code expansion of `libacm_tpu/ops/synth_jax.py::
synth_pcm_cols` and its `_bytes_le`. The source is `csrc/unpack.cu`,
compiled with nvcc for sm_90a at first use into `synth_cuda.build_dir()`
(its own hash-keyed shared object beside the synthesis kernel's) and bound
with ctypes through a plain C interface.

`unpack_cols_blob` is a drop-in for `synth_torch.unpack_cols_blob_plain`
(same arguments, same bits). CPU tensors take that plain version; CUDA
tensors launch the kernel or raise — never the torch ops.

Every call with anything to write launches one kernel (`unpack`): width
tiles, column tiles and the vals / wrap0 conversion, in ticket order, with
a decoupled look-back across tiles (`plan` says how the call is cut). Its
status words live in a scratch buffer kept per device and stream
(`_Scratch`): each call takes a new epoch, so the words need no reset and
the call makes no other device operation.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from . import synth_cuda, synth_torch
from .kernels import Launches

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "unpack.cu"

#: the kernel's constants (csrc/unpack.cu): nibbles per width tile,
#: columns per tile at most, threads a CTA, bits per family in a packed
#: sum; status words: value bits and the epoch's shift
WT = 2048
TC_MAX = 2048
THREADS = 256
FIELD = 21
VBITS = 38
EPOCH_SHIFT = 40
#: a column tile holds about this many values (tc = 2^ltc columns),
#: halved while the call has fewer than TARGET_TILES tiles, down to
#: MIN_TILE_VALUES (short segments and windows spread over the SMs)
TILE_VALUES = 32768
MIN_TILE_VALUES = 2048
TARGET_TILES = 264
#: the status-word epochs a scratch buffer runs through before it is
#: zeroed again (24 bits), and the words it is first made with
EPOCHS = 1 << 24
SCRATCH_WORDS = 1 << 16

#: launches per kernel since the last reset_launches()
launches = Launches("unpack")
reset_launches = launches.reset

_lib = None
_LOCK = threading.Lock()


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/unpack.cu for sm_90a into synth_cuda.build_dir()
    (cached by source hash): (shared object, nvcc's -Xptxas -v report,
    empty when it was already built)."""
    return synth_cuda.compile_source(_SRC, "unpack")


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.acm_unpack.restype = ci
            lib.acm_unpack.argtypes = [
                vp, ctypes.POINTER(ctypes.c_longlong), vp,  # blob, geo, status
                vp, vp, vp, ci, ci, vp,  # vals, wrap0, k, grid, smem, stream
            ]
            lib.acm_unpack_attributes.restype = ci
            lib.acm_unpack_attributes.argtypes = [ci]
            _lib = lib
    return _lib


#: (library, device index) pairs whose kernel attribute is set
_attributed: set[tuple[int, int]] = set()


def attributes(lib, device: torch.device) -> None:
    """Set the kernel's dynamic shared memory to the most a call asks
    (SMEM_MAX), once per library and card, under the wrapper's lock. A
    launch never sets it: a setting between another thread's setting and
    its launch broke that launch."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (id(lib), index)
    if key in _attributed:
        return
    with _LOCK:
        if key in _attributed:
            return
        with torch.cuda.device(index):
            _raise(lib.acm_unpack_attributes(SMEM_MAX), "unpack_attributes")
        _attributed.add(key)


def tile_columns(level: int, rows: int, ncols: int) -> int:
    """Columns per column tile, a power of two: about TILE_VALUES values
    (at most TC_MAX columns), halved while the call has fewer than
    TARGET_TILES tiles and a tile more than MIN_TILE_VALUES values; never
    fewer than min(cols, 8), so that a tile is whole blocks or a run of
    at least 8 columns of one block."""
    cols = 1 << level
    tc = min(TC_MAX, 1 << (max(TILE_VALUES // rows, 1).bit_length() - 1))
    while (tc > 1 and tc * rows > MIN_TILE_VALUES
           and -(-ncols // tc) < TARGET_TILES):
        tc //= 2
    return max(tc, min(cols, 8))


def plan(level: int, rows: int, batch: int, nb: int,
         lens: tuple[int, int, int, int, int, int], has_wrap: bool) -> dict:
    """The launch geometry of one call (csrc/unpack.cu's Geo, as a dict,
    without the epoch and ticket base): column tiles of 2^ltc columns,
    width tiles per family, the vals / wrap0 CTAs, the CTAs in all
    (width tiles first, then column tiles, then the conversion), the
    staged spans' shared memory and the CTA's dynamic shared memory."""
    cols = 1 << level
    secs, total = synth_torch.cols_blob_layout(level, batch, nb, lens,
                                               has_wrap=has_wrap)
    ncols = batch * nb * cols
    tc = tile_columns(level, rows, ncols)
    nct = -(-ncols // tc)
    present = [int(ncols > 0 and lens[f] >= 2 and lens[3 + f] >= 1)
               for f in range(3)]
    nwt = [-(-2 * lens[3 + f] // WT) if present[f] else 0 for f in range(3)]
    wbase = [0, nwt[0], nwt[0] + nwt[1]]
    nvals = batch * nb
    nwrap = batch * (2 * cols - 2) if has_wrap else 0
    nvw = min(-(-(nvals + nwrap) // (4 * THREADS)), 64)
    span = 2 * tc * rows + 3 * 48
    return {"secs": secs, "total": total, "ncols": ncols, "nct": nct,
            "present": present, "nwt": nwt, "wbase": wbase, "nvals": nvals,
            "nwrap": nwrap, "nvw": nvw, "ltc": tc.bit_length() - 1,
            "span": span, "smem": span + 4 * tc,
            "grid": sum(nwt) + nct + nvw, "stride": (cols + 3) // 4,
            "magic": -(-(1 << 32) // rows)}


#: the most dynamic shared memory a call asks: plan's "smem" at the widest
#: column tile of any rows (no call halves it further up)
SMEM_MAX = max(2 * tc * rows + 3 * 48 + 4 * tc for rows in range(1, 4096)
               for tc in [tile_columns(15, rows, 1 << 40)])


def unpack_launches(level: int, batch: int, nb: int,
                    has_wrap: bool) -> dict[str, int]:
    """The launches one call of unpack_cols_blob makes, by kernel: one
    where there are columns, or vals or wrap0 to convert; none for an
    empty call."""
    if batch * nb or (has_wrap and batch and level):
        return {"unpack": 1}
    return {}


def geometry(p: dict, level: int, rows: int, epoch: int,
             ticket0: int) -> ctypes.Array:
    """The 40 long longs csrc/unpack.cu's geo_from reads."""
    vals = ([o for o, _ in p["secs"]] + [0] * (9 - len(p["secs"]))
            + [n for _, n in p["secs"]] + [0] * (9 - len(p["secs"]))
            + [p["ncols"], level, rows, p["stride"], p["nct"]]
            + p["present"] + p["nwt"] + p["wbase"]
            + [p["nvals"], p["nwrap"], p["nvw"], p["ltc"], p["span"],
               p["magic"], epoch, ticket0])
    return (ctypes.c_longlong * len(vals))(*vals)


class _Scratch:
    """The kernel's ticket counter (word 0) and status words, one buffer
    per (device, stream), zeroed once when made: each call takes the next
    epoch and the ticket count so far, so stale words of earlier calls
    read as not ready. Calls on one stream run in order, so they share
    the buffer safely; another stream gets its own."""

    _by_key: dict = {}
    _lock = threading.Lock()

    def __init__(self, dev: torch.device, words: int):
        self.words = torch.zeros(max(words, SCRATCH_WORDS),
                                 dtype=torch.int64, device=dev)
        self.epoch = 0
        self.tickets = 0

    @classmethod
    def take(cls, dev: torch.device, stream: int, words: int):
        """(buffer, epoch, tickets handed out before) for one call of
        `words` status words (the counter included)."""
        key = (dev.index, stream)
        s = cls._by_key.get(key)
        if s is None or s.words.numel() < words:
            s = cls._by_key[key] = cls(dev, words)
        s.epoch += 1
        if s.epoch == EPOCHS:  # epochs wrap: no stale word may match
            s.words.zero_()
            s.epoch, s.tickets = 1, 0
        return s


def _raise(rc: int, kernel: str) -> None:
    if rc:
        raise RuntimeError(f"{kernel}_kernel launch failed: cudaError {rc}")


def unpack_cols_blob(
    blob: torch.Tensor,  # uint8 [total]: all wire sections coalesced
    *,
    level: int,
    rows: int,
    batch: int,
    nb: int,
    lens: tuple[int, int, int, int, int, int],
    has_wrap: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(k int16 [batch, nb, rows, cols], vals int32 [batch, nb], wrap0
    int32 [batch, 2*cols-2] or None), bit-identical to
    synth_torch.unpack_cols_blob_plain. CPU tensors take that plain
    version; CUDA tensors launch the kernel."""
    if blob.device.type == "cpu":
        return synth_torch.unpack_cols_blob_plain(
            blob, level=level, rows=rows, batch=batch, nb=nb, lens=lens,
            has_wrap=has_wrap)
    if blob.device.type != "cuda":
        raise ValueError(f"no unpack kernel for device {blob.device}")
    if not 0 <= level <= 15 or not 1 <= rows <= 4095 or batch < 0 or nb < 0:
        raise ValueError(f"bad geometry level={level} rows={rows} "
                         f"batch={batch} nb={nb} (the format's rows are "
                         "12-bit)")
    lens = tuple(int(n) for n in lens)
    if len(lens) != 6 or min(lens) < 0:
        raise ValueError(f"lens must be six section sizes, got {lens}")
    p = plan(level, rows, batch, nb, lens, has_wrap)
    if blob.dtype != torch.uint8 or tuple(blob.shape) != (p["total"],):
        raise ValueError(f"wire blob must be uint8 of shape ({p['total']},), "
                         f"got {blob.dtype} {tuple(blob.shape)}")
    if not blob.is_contiguous():
        raise ValueError("wire blob must be contiguous")
    for f, name in enumerate(("pay4", "pay8", "pay16")):
        if p["present"][f] and lens[f] % 2:
            raise ValueError(f"{name} has {lens[f]} bytes: a payload is read "
                             "as uint16 words and must have an even length")
    if p["ncols"] >= 1 << 31 or max(lens) >= 1 << 32:
        raise ValueError(f"{p['ncols']} columns, sections {lens}: too large "
                         "for one call")
    cols = 1 << level
    dev = blob.device
    k = torch.empty((batch, nb, rows, cols), dtype=torch.int16, device=dev)
    vals = torch.empty((batch, nb), dtype=torch.int32, device=dev)
    wrap0 = (torch.empty((batch, 2 * cols - 2), dtype=torch.int32,
                         device=dev) if has_wrap else None)
    if not unpack_launches(level, batch, nb, has_wrap):
        return k, vals, wrap0
    lib = _load()
    attributes(lib, dev)
    words = 1 + sum(p["nwt"]) + 3 * p["nct"]
    with torch.cuda.device(dev), _Scratch._lock:
        stream = torch.cuda.current_stream(dev).cuda_stream
        s = _Scratch.take(dev, stream, words)
        geo = geometry(p, level, rows, s.epoch, s.tickets % (1 << 32))
        _raise(lib.acm_unpack(
            blob.data_ptr(), geo, s.words.data_ptr(), vals.data_ptr(),
            wrap0.data_ptr() if wrap0 is not None else None, k.data_ptr(),
            p["grid"], p["smem"], stream), "unpack")
        s.tickets += p["grid"]
    launches.count("unpack")
    return k, vals, wrap0
