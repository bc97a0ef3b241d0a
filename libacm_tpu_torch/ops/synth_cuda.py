"""CUDA synthesis kernel for Hopper: build, ctypes binding and dispatch.

Replaces the Pallas TPU kernel `libacm_tpu/ops/synth_pallas.py::_kernel`
(launched by `synth_pcm_pallas`). The source is `csrc/synth.cu`; it is
compiled with nvcc for sm_90a at first use (into $LIBACM_TPU_TORCH_CACHE
when that is set, beside the scanner's objects, else into `_build/` in the
package) and bound with ctypes through a plain C interface.

`synth_pcm_batch` is a drop-in for `ops.synth_torch.synth_pcm_batch`
(same arguments, same bits, wrap_f included). For CPU tensors it runs that
plain version; for CUDA tensors it launches a kernel or raises — it never
falls back to tensor ops.

Bound: k is read (2 bytes) and PCM written (2 bytes) once per sample,
against about 2*level+2 int32 operations (dequantize, two adds per FIR
pass, the shift). On an H100 that makes the bytes bound the larger at
7/16, 4/40 and level 0 and the operations bound the larger at 10/4
(bench_torch.py `bound`). Three routes, by geometry:

- fused (`synth_fused_kernel`): level >= 1 and a tile of one block fits
  one CTA's shared memory: tiles for two CTAs per SM where one block
  leaves room for two, else for one. One launch per call. Each CTA
  walks a span of consecutive blocks of one file in tiles of T blocks,
  carrying the halo between tiles; a span that does not start at block 0
  first synthesizes the W = synth_torch.warmup_blocks(level, rows) blocks
  before it (1 for rows >= 2, 2 for rows == 1) from a zero carry, or from
  wrap0 where they reach block 0, and drops their PCM. k is prefetched
  into shared memory while the previous tile's passes run; the passes
  walk strips in place, the last three run in registers and write
  16-byte PCM stores.
  `fused_plan` sizes the tile for the resident CTAs per SM and the spans
  for about one wave of them.
- level 0 (`synth_level0_kernel`): one launch; k * val in 16-byte vectors
  where n and the alignment of k allow (`level0_plan`).
- blocks over one CTA's shared memory (`synth_pass_kernel`, then
  `synth_tail_kernel`): one flat launch over each file's stream in device
  memory per pass wider than TAIL_STRIDE, in 16-byte accesses, then one
  launch of the remaining passes over flat tiles in shared memory with a
  recomputed halo (`tail_pass`, `tail_halo`).

`kernel_launches` says which kernels one call launches at a geometry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from . import synth_torch
from .kernels import Launches

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE.parent / "csrc" / "synth.cu"
#: environment variable naming the build directory (the scanner copy's
#: too, scan/native.py); unset: `_build/` in the package
CACHE_ENV = "LIBACM_TPU_TORCH_CACHE"

#: shared memory the CTAs resident on one SM share (228 KB), and what the
#: runtime reserves for each CTA
SM_SMEM = 233472
CTA_RESERVED = 1024
#: a fused tile's budget: two CTAs resident per SM
TILE_SMEM = SM_SMEM // 2 - CTA_RESERVED
#: the budget where one block does not fit TILE_SMEM: one CTA per SM (the
#: opt-in limit of one CTA's dynamic shared memory, 227 KB)
ONE_CTA_SMEM = SM_SMEM - CTA_RESERVED
#: threads per fused CTA: a power of two (the kernel sizes strips by
#: shifts), at most the kernel's __launch_bounds__
_FUSED_THREADS = 256
_LEVEL0_THREADS = 256
_PASS_THREADS = 256
_TAIL_THREADS = 512
_MAX_GRID_X = 65535
#: the widest pass stride the tail kernel takes in shared memory; the
#: passes wider than this are flat launches of synth_pass_kernel
TAIL_STRIDE = 1024
#: outputs per tail CTA: at least the halo, 4 * TAIL_STRIDE; the halo adds
#: at most half a tile to the first tail pass, and two buffers of tile and
#: halo (96 KB) leave room for two CTAs per SM
TAIL_TILE = 8192

#: launches per kernel since the last reset_launches()
launches = Launches("synth_fused", "synth_level0", "synth_pass",
                    "synth_tail")
reset_launches = launches.reset

_lib = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((pathlib.Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME)")


def build_dir() -> pathlib.Path:
    """Where the kernel's shared object is built and looked up:
    $LIBACM_TPU_TORCH_CACHE when set (so that an install whose package
    directory cannot be written still builds), else `_build/` in the
    package."""
    return pathlib.Path(os.environ.get(CACHE_ENV) or _HERE.parent / "_build")


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/synth.cu for sm_90a into build_dir() (cached by source
    hash).

    Returns (shared object path, nvcc's -Xptxas -v report; empty when the
    library was already built).
    """
    return compile_source(_SRC, "synth")


def compile_source(path: pathlib.Path, stem: str) -> tuple[pathlib.Path, str]:
    """Compile one CUDA source for sm_90a into build_dir() as
    `<stem>-<source hash>.so` (cached by that hash): (shared object,
    nvcc's -Xptxas -v report; empty when it was already built)."""
    src = path.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out_dir = build_dir()
    so = out_dir / f"{stem}-{tag}.so"
    if so.exists():
        return so, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".so", dir=out_dir,
                                     delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp_path), str(path)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    tmp_path.replace(so)  # atomic under concurrent builders
    return so, r.stderr


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.acm_synth_fused.restype = ci
            lib.acm_synth_fused.argtypes = [
                vp, vp, vp, vp, vp,  # k, vals, wrap0, pcm, wrapf
                ci, ci, ci, ci, ci, ci,  # B, nb, level, rows, T, span
                ci, ci,  # warm-up blocks, threads
                ctypes.c_longlong, vp,  # smem bytes, stream
            ]
            lib.acm_synth_attributes.restype = ci
            lib.acm_synth_attributes.argtypes = [ctypes.c_longlong,
                                                 ctypes.c_longlong]
            lib.acm_synth_occupancy.restype = ci
            lib.acm_synth_occupancy.argtypes = [ci, ci, ctypes.c_longlong]
            lib.acm_synth_level0.restype = ci
            lib.acm_synth_level0.argtypes = [
                vp, vp, vp, ctypes.c_longlong, ci,  # k, vals, pcm, nblk, n
                ci, ci, ci, ci, ci, vp,  # vec, tx, ty, gx, gy, stream
            ]
            lib.acm_synth_pass.restype = ci
            lib.acm_synth_pass.argtypes = [
                vp, vp, vp, vp, vp, vp,  # k, xin, vals, wrap0, xout, wrapf
                ci, ci, ci, ci, ci, ci,  # B, nb, level, rows, p, k8
                ci, ci, vp,  # grid_x, threads, stream
            ]
            lib.acm_synth_tail.restype = ci
            lib.acm_synth_tail.argtypes = [
                vp, vp, vp, vp, vp, vp,  # k, xin, vals, wrap0, pcm, wrapf
                ci, ci, ci, ci, ci, ci, ci,  # B, nb, level, rows, p0, TL, vec
                ci, ci, ctypes.c_longlong, vp,  # grid_x, threads, smem, stream
            ]
            _lib = lib
    return _lib


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_smem_bytes(level: int, rows: int, T: int) -> int:
    """Shared memory of one fused CTA: the carry [2*cols-2] and the vals
    of two tiles (int32), one pass buffer of T blocks (int32), and two
    staging buffers of T blocks of k (int16)."""
    cols = 1 << level
    tile = _up(T * rows * cols, 8)
    return 4 * (_up(2 * cols - 2, 4) + _up(2 * T, 4) + tile) + 2 * 2 * tile


def fused_budget(level: int, rows: int) -> int:
    """Shared memory a fused CTA may take: TILE_SMEM (two CTAs per SM)
    where one block fits it, else ONE_CTA_SMEM (one CTA per SM)."""
    return (TILE_SMEM if fused_smem_bytes(level, rows, 1) <= TILE_SMEM
            else ONE_CTA_SMEM)


def fused_tile(level: int, rows: int, nb: int) -> int:
    """Blocks per tile on the fused route: the largest tile, at most nb,
    that fits fused_budget (two CTAs per SM where one block leaves room
    for two, else one); 0 where the route does not apply (level 0, or not
    even one block fits one CTA).
    """
    budget = fused_budget(level, rows)
    if level < 1 or fused_smem_bytes(level, rows, 1) > budget:
        return 0
    lo, hi = 1, max(nb, 1)
    while lo < hi:  # largest T in [1, nb] that fits the budget
        mid = (lo + hi + 1) // 2
        if fused_smem_bytes(level, rows, mid) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def fused_plan(level: int, rows: int, B: int, nb: int,
               slots: int) -> tuple[int, int]:
    """(T, span) of a fused launch: tiles of T blocks, spans of `span`
    consecutive blocks of one file per CTA.

    `slots` is the number of CTAs resident on the card at fused_tile's
    tile (SMs x CTAs per SM). Each file is cut into slots // B spans of
    equal length (at least one), so the grid of B * ceil(nb / span) CTAs
    is at most one wave where B <= slots. A span that does not start at
    block 0 also synthesizes the W = synth_torch.warmup_blocks(level, rows)
    blocks before it, so a tile larger than span + W blocks is cut to that.
    """
    T = fused_tile(level, rows, nb)
    if not T:
        return 0, 0
    span = -(-nb // max(1, min(slots // max(B, 1), nb)))
    return min(T, span + synth_torch.warmup_blocks(level, rows)), span


def level0_plan(n: int, k_addr: int, pcm_addr: int) -> tuple[int, int, int]:
    """(vec, tx, ty) of a level-0 launch over blocks of n samples: vec
    samples a thread, the widest of 8, 4, 2, 1 that divides n and keeps
    every vector of k and of PCM aligned to 2*vec bytes (one 16-, 8-, 4- or
    2-byte access each); CTAs of tx vectors of a block by ty blocks, at
    most _LEVEL0_THREADS threads."""
    vec = next(v for v in (8, 4, 2, 1) if n % v == 0
               and k_addr % (2 * v) == 0 and pcm_addr % (2 * v) == 0)
    tx = min(n // vec, _LEVEL0_THREADS)
    return vec, tx, max(1, _LEVEL0_THREADS // tx)


def tail_pass(level: int) -> int:
    """Where one block fits no CTA: the first pass of the tail launch,
    the first whose stride is at most TAIL_STRIDE. The passes before it
    are flat launches (pass 0 dequantizes k)."""
    return max(0, level - TAIL_STRIDE.bit_length())


def tail_halo(level: int) -> int:
    """Inputs a tail tile loads before its outputs: 4 * s_p0 >= sum of
    2*s over the tail's passes, + 2."""
    return 4 * ((1 << level) >> (tail_pass(level) + 1))


def tail_smem_bytes(level: int) -> int:
    """Shared memory of one tail CTA: two int32 buffers of halo + tile."""
    return 2 * 4 * (tail_halo(level) + TAIL_TILE)


#: the most shared memory a tail CTA takes, at any level
TAIL_SMEM_MAX = max(tail_smem_bytes(level) for level in range(16))

#: (library, device index) pairs whose kernel attributes are set
_attributed: set[tuple[int, int]] = set()


def attributes(lib, device: torch.device) -> None:
    """Set the fused and tail kernels' dynamic shared memory to the most
    their wrapper asks (ONE_CTA_SMEM, TAIL_SMEM_MAX) and the fused
    kernel's carveout, once per library and card, under the wrappers'
    lock. The launches never set them: a setting between another thread's
    setting and its launch broke that launch."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (id(lib), index)
    if key in _attributed:
        return
    with _LOCK:
        if key in _attributed:
            return
        with torch.cuda.device(index):
            rc = lib.acm_synth_attributes(ONE_CTA_SMEM, TAIL_SMEM_MAX)
        if rc:
            raise RuntimeError(f"setting the synthesis kernels' shared "
                               f"memory failed: cudaError {rc}")
        _attributed.add(key)


def kernel_launches(level: int, rows: int, nb: int) -> dict[str, int]:
    """The launches one call of synth_pcm_batch makes on [B, nb] blocks
    of this geometry (nb > 0), by kernel."""
    if level == 0:
        return {"synth_level0": 1}
    if fused_tile(level, rows, nb):
        return {"synth_fused": 1}
    p0 = tail_pass(level)
    return ({"synth_pass": p0} if p0 else {}) | {"synth_tail": 1}


def route(level: int, rows: int, nb: int) -> str:
    """The kernels a geometry's call launches, joined by '+'."""
    return "+".join(kernel_launches(level, rows, nb))


_occupancy: dict[tuple[int, str, int], int] = {}
#: the occupancy query's kernel index and threads per CTA of each kernel
_KERNELS = {"synth_fused": (0, _FUSED_THREADS),
            "synth_level0": (1, _LEVEL0_THREADS)}


def ctas_per_sm(kernel: str, smem_bytes: int, device: torch.device) -> int:
    """Resident CTAs per SM of the main path's kernels ("synth_fused" at
    this dynamic shared memory, or "synth_level0"), as the CUDA runtime
    reports it (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    key = (device.index or 0, kernel, smem_bytes)
    if key not in _occupancy:
        lib = _load()
        attributes(lib, device)
        index, threads = _KERNELS[kernel]
        with torch.cuda.device(device):
            n = lib.acm_synth_occupancy(index, threads, smem_bytes)
        if n <= 0:
            raise RuntimeError(f"occupancy query for {kernel} failed: "
                               f"cudaError {-n}")
        _occupancy[key] = n
    return _occupancy[key]


def fused_config(level: int, rows: int, B: int, nb: int,
                 device: torch.device) -> dict | None:
    """The fused launch the wrapper makes on this card for [B, nb] blocks
    (None where the fused route does not apply): tile, span, grid, shared
    memory per CTA and resident CTAs per SM."""
    T0 = fused_tile(level, rows, nb)
    if not T0 or not B or not nb:
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slots = sms * ctas_per_sm("synth_fused",
                              fused_smem_bytes(level, rows, T0), device)
    T, span = fused_plan(level, rows, B, nb, slots)
    smem = fused_smem_bytes(level, rows, T)
    return {"T": T, "span": span, "grid": (-(-nb // span), B),
            "threads": _FUSED_THREADS, "smem_bytes": smem,
            "ctas_per_sm": ctas_per_sm("synth_fused", smem, device)}


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, k on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def synth_pcm_batch(
    k: torch.Tensor,  # int16 [B, nb, rows, cols]
    vals: torch.Tensor,  # int32 [B, nb]
    wrap0: torch.Tensor,  # int32 [B, 2*cols-2]
    *,
    level: int,
    rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pcm int16 [B, nb, rows*cols], wrap_f int32 [B, 2*cols-2]).

    Bit-identical to synth_torch.synth_pcm_batch. CPU tensors take that
    plain version; CUDA tensors launch the kernel.
    """
    if k.device.type == "cpu":
        return synth_torch.synth_pcm_batch(k, vals, wrap0, level=level,
                                           rows=rows)
    if k.device.type != "cuda":
        raise ValueError(f"no synthesis kernel for device {k.device}")
    if not 0 <= level <= 15 or rows < 1:
        raise ValueError(f"bad geometry level={level} rows={rows}")
    cols = 1 << level
    n = rows * cols
    B, nb = k.shape[0], k.shape[1]
    dev = k.device
    _check(k, "k", torch.int16, (B, nb, rows, cols), dev)
    _check(vals, "vals", torch.int32, (B, nb), dev)
    if level:
        _check(wrap0, "wrap0", torch.int32, (B, 2 * cols - 2), dev)
    elif wrap0.shape[0] != B:
        raise ValueError(f"wrap0 must have {B} rows, got {wrap0.shape[0]}")
    if B > 65535 or nb * n >= 1 << 31:
        raise ValueError(f"batch too large for one launch: B={B}, "
                         f"{nb * n} words per file")
    pcm = torch.empty((B, nb, n), dtype=torch.int16, device=dev)
    if nb == 0 or B == 0:
        return pcm, wrap0
    wrapf = (torch.empty((B, 2 * cols - 2), dtype=torch.int32, device=dev)
             if level else wrap0)
    lib = _load()
    attributes(lib, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if level == 0:
            vec, tx, ty = level0_plan(n, k.data_ptr(), pcm.data_ptr())
            rc = lib.acm_synth_level0(
                k.data_ptr(), vals.data_ptr(), pcm.data_ptr(), B * nb, n, vec,
                tx, ty, -(-(B * nb) // ty), -(-(n // vec) // tx), stream)
            if rc:
                raise RuntimeError(f"synth_level0_kernel launch failed: "
                                   f"cudaError {rc}")
            launches.count("synth_level0")
            return pcm, wrapf
        cfg = fused_config(level, rows, B, nb, dev)
        if cfg:
            rc = lib.acm_synth_fused(
                k.data_ptr(), vals.data_ptr(), wrap0.data_ptr(),
                pcm.data_ptr(), wrapf.data_ptr(), B, nb, level, rows,
                cfg["T"], cfg["span"], synth_torch.warmup_blocks(level, rows),
                _FUSED_THREADS, cfg["smem_bytes"], stream)
            if rc:
                raise RuntimeError(f"synth_fused_kernel launch failed: "
                                   f"cudaError {rc}")
            launches.count("synth_fused")
            return pcm, wrapf
        # a block fits no CTA: the wide passes flat, then the tail in tiles
        L = nb * n
        p0 = tail_pass(level)
        bufs = [torch.empty((B, L), dtype=torch.int32, device=dev)
                for _ in range(min(2, p0))]
        src = None
        for p in range(p0):
            dst = bufs[p % 2]
            rc = lib.acm_synth_pass(
                k.data_ptr(), src.data_ptr() if src is not None else None,
                vals.data_ptr(), wrap0.data_ptr(), dst.data_ptr(),
                wrapf.data_ptr(), B, nb, level, rows, p,
                int(k.data_ptr() % 8 == 0),
                min(-(-L // (4 * _PASS_THREADS)), _MAX_GRID_X), _PASS_THREADS,
                stream)
            if rc:
                raise RuntimeError(f"synth_pass_kernel launch failed (pass "
                                   f"{p}): cudaError {rc}")
            launches.count("synth_pass")
            src = dst
        rc = lib.acm_synth_tail(
            k.data_ptr(), src.data_ptr() if src is not None else None,
            vals.data_ptr(), wrap0.data_ptr(), pcm.data_ptr(),
            wrapf.data_ptr(), B, nb, level, rows, p0, TAIL_TILE,
            int(pcm.data_ptr() % 16 == 0 and L % 8 == 0), -(-L // TAIL_TILE),
            _TAIL_THREADS, tail_smem_bytes(level), stream)
        if rc:
            raise RuntimeError(f"synth_tail_kernel launch failed: cudaError "
                               f"{rc}")
        launches.count("synth_tail")
    return pcm, wrapf
