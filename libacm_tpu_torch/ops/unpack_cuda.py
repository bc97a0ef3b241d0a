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
tensors launch the kernels or raise — never the torch ops.

Every call with columns launches three kernels (`unpack_launches`): the
reduce (per-tile family counts, width-tile nibble prefixes, vals and
wrap0 from bytes), a one-CTA scan of the tile totals, and the values
(one thread per value, k rows-major). Scratch comes from the caching
allocator on the blob's device, on its current stream.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from . import synth_cuda, synth_torch

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "unpack.cu"

#: the kernel's tile sizes (csrc/unpack.cu): columns per tile, nibbles per
#: width tile, threads of the reduce and value CTAs
TC = 1024
WT = 2048
THREADS = 256
#: the value kernel cuts each column tile into runs of rows until about
#: this many CTAs are in flight
VALUE_CTAS = 1024

#: launches per kernel since the last reset_launches()
launches = {"unpack_reduce": 0, "unpack_scan": 0, "unpack_values": 0}

_lib = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LOCK:
        for name in launches:
            launches[name] = 0


def _count(kernel: str) -> None:
    with _LOCK:
        launches[kernel] += 1


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
            geo = ctypes.POINTER(ctypes.c_longlong)
            lib.acm_unpack_reduce.restype = ci
            lib.acm_unpack_reduce.argtypes = [
                vp, geo, vp, vp, vp, vp, vp, vp,  # blob, geo, tcnt, wsum,
            ]                                     # nploc, vals, wrap0, stream
            lib.acm_unpack_scan.restype = ci
            lib.acm_unpack_scan.argtypes = [geo, vp, vp, vp]
            lib.acm_unpack_values.restype = ci
            lib.acm_unpack_values.argtypes = [vp, geo, vp, vp, vp, vp, vp]
            _lib = lib
    return _lib


def plan(level: int, rows: int, batch: int, nb: int,
         lens: tuple[int, int, int, int, int, int], has_wrap: bool) -> dict:
    """The launch geometry of one call: column tiles, width tiles per
    family, the vals / wrap0 CTAs and the rows per value CTA (the layout
    of csrc/unpack.cu's Geo, as a dict)."""
    cols = 1 << level
    secs, total = synth_torch.cols_blob_layout(level, batch, nb, lens,
                                               has_wrap=has_wrap)
    ncols = batch * nb * cols
    nct = -(-ncols // TC)
    present = [int(ncols > 0 and lens[f] >= 2 and lens[3 + f] >= 1)
               for f in range(3)]
    nwt = [-(-2 * lens[3 + f] // WT) if present[f] else 0 for f in range(3)]
    wbase = [0, nwt[0], nwt[0] + nwt[1]]
    nvals = batch * nb
    nwrap = batch * (2 * cols - 2) if has_wrap else 0
    nvw = min(-(-(nvals + nwrap) // (4 * THREADS)), 64)
    ysplit = max(1, min(rows, -(-VALUE_CTAS // max(nct, 1))))
    return {"secs": secs, "total": total, "ncols": ncols, "nct": nct,
            "present": present, "nwt": nwt, "wbase": wbase, "nvals": nvals,
            "nwrap": nwrap, "nvw": nvw, "rs": -(-rows // ysplit),
            "stride": (cols + 3) // 4}


def unpack_launches(level: int, batch: int, nb: int,
                    has_wrap: bool) -> dict[str, int]:
    """The launches one call of unpack_cols_blob makes, by kernel: the
    three kernels where there are columns, the reduce alone where there
    are only vals or wrap0 to convert, none for an empty call."""
    if batch * nb:
        return {"unpack_reduce": 1, "unpack_scan": 1, "unpack_values": 1}
    if has_wrap and batch and level:
        return {"unpack_reduce": 1}
    return {}


def geometry(p: dict, level: int, rows: int) -> ctypes.Array:
    """The 36 long longs csrc/unpack.cu's geo_from reads."""
    vals = ([o for o, _ in p["secs"]] + [0] * (9 - len(p["secs"]))
            + [n for _, n in p["secs"]] + [0] * (9 - len(p["secs"]))
            + [p["ncols"], level, rows, p["stride"], p["nct"]]
            + p["present"] + p["nwt"] + p["wbase"]
            + [p["nvals"], p["nwrap"], p["nvw"], p["rs"]])
    return (ctypes.c_longlong * len(vals))(*vals)


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
    version; CUDA tensors launch the kernels."""
    if blob.device.type == "cpu":
        return synth_torch.unpack_cols_blob_plain(
            blob, level=level, rows=rows, batch=batch, nb=nb, lens=lens,
            has_wrap=has_wrap)
    if blob.device.type != "cuda":
        raise ValueError(f"no unpack kernel for device {blob.device}")
    if not 0 <= level <= 15 or rows < 1 or batch < 0 or nb < 0:
        raise ValueError(f"bad geometry level={level} rows={rows} "
                         f"batch={batch} nb={nb}")
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
    if p["ncols"] >= 1 << 31:
        raise ValueError(f"{p['ncols']} columns: too many for one call")
    cols = 1 << level
    dev = blob.device
    k = torch.empty((batch, nb, rows, cols), dtype=torch.int16, device=dev)
    vals = torch.empty((batch, nb), dtype=torch.int32, device=dev)
    wrap0 = (torch.empty((batch, 2 * cols - 2), dtype=torch.int32,
                         device=dev) if has_wrap else None)
    per_call = unpack_launches(level, batch, nb, has_wrap)
    if not per_call:
        return k, vals, wrap0
    nwt_all = sum(p["nwt"])
    tcnt = torch.empty(max(3 * p["nct"], 1), dtype=torch.int32, device=dev)
    wsum = torch.empty(max(nwt_all, 1), dtype=torch.int64, device=dev)
    nploc = torch.empty(max(nwt_all * WT, 1), dtype=torch.int32, device=dev)
    geo = geometry(p, level, rows)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise(lib.acm_unpack_reduce(
            blob.data_ptr(), geo, tcnt.data_ptr(), wsum.data_ptr(),
            nploc.data_ptr(), vals.data_ptr(),
            wrap0.data_ptr() if wrap0 is not None else None, stream),
            "unpack_reduce")
        _count("unpack_reduce")
        if "unpack_scan" in per_call:
            _raise(lib.acm_unpack_scan(geo, tcnt.data_ptr(), wsum.data_ptr(),
                                       stream), "unpack_scan")
            _count("unpack_scan")
            _raise(lib.acm_unpack_values(
                blob.data_ptr(), geo, tcnt.data_ptr(), wsum.data_ptr(),
                nploc.data_ptr(), k.data_ptr(), stream), "unpack_values")
            _count("unpack_values")
    return k, vals, wrap0
