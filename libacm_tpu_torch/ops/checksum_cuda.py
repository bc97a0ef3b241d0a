"""CUDA masked content digest for Hopper: build, ctypes binding, dispatch.

Replaces the device work that the JAX package compiles with XLA for
`DeviceCorpus.checksum` (no Pallas kernel): `libacm_tpu/parallel/
corpus.py::_sum_all`. The source is `csrc/checksum.cu`, compiled with
nvcc for sm_90a at first use into `synth_cuda.build_dir()` (its own
hash-keyed shared object) and bound with ctypes through a plain C
interface.

`sum_all(pcms, ngs)` sums, over the chunks of one device (pcm int16
[B, nb, L], ng [B] good blocks a row), the first ng[j]*L words of every
row j. CPU tensors take `sum_all_plain`, the torch ops; CUDA tensors
launch the kernel or raise. A call on a card makes three device
operations: the span table's copy to the card (`plan`), one launch over
every chunk, and the caller's fetch of the scalar — no memset, since the
table's word 0 is the accumulator and is copied as 0.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from collections.abc import Sequence

import numpy as np
import torch

from . import synth_cuda
from .kernels import Launches

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "checksum.cu"

#: the kernel's constants (csrc/checksum.cu): threads a CTA, 16-byte
#: vectors a tile, and the CTAs a launch asks for on each SM
THREADS = 256
TILE_VECS = 4096
CTAS_PER_SM = 8
#: int64 words a span takes in the table, after the accumulator word
SPAN_WORDS = 4

#: launches per kernel since the last reset_launches()
launches = Launches("checksum")
reset_launches = launches.reset

_lib = None
_LOCK = threading.Lock()


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/checksum.cu for sm_90a into synth_cuda.build_dir()
    (cached by source hash): (shared object, nvcc's -Xptxas -v report,
    empty when it was already built)."""
    return synth_cuda.compile_source(_SRC, "checksum")


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.acm_checksum.restype = ci
            lib.acm_checksum.argtypes = [
                vp, ci, ctypes.c_longlong, ci, vp,  # table, spans, tiles,
            ]                                       # grid, stream
            _lib = lib
    return _lib


def good_rows(ng: np.ndarray, nb: int) -> np.ndarray:
    """ng clamped to [0, nb], as int64."""
    return np.clip(np.asarray(ng, dtype=np.int64), 0, nb)


def sum_all_plain(pcms: Sequence[torch.Tensor],
                  ngs: Sequence[np.ndarray]) -> torch.Tensor:
    """The masked sum as torch ops on the chunks' device: an int64 scalar
    tensor whose value modulo 2^32 is the digest (the int64 sum taken
    & 0xFFFFFFFF equals the JAX package's wrapped int32 sum)."""
    tot = None
    for pcm, ng in zip(pcms, ngs):
        dev = pcm.device
        ng = torch.from_numpy(good_rows(ng, pcm.shape[1])).to(dev)
        mask = torch.arange(pcm.shape[1], device=dev)[None, :] < ng[:, None]
        per_block = pcm.sum(dim=2, dtype=torch.int64)
        part = torch.where(mask, per_block, 0).sum()
        tot = part if tot is None else tot + part
    return torch.zeros((), dtype=torch.int64) if tot is None else tot


def plan(spans) -> tuple[np.ndarray, int, int]:
    """The kernel's table for (address in bytes, words) spans (pairs, or
    an int64 [S, 2] array): (int64 [1 + SPAN_WORDS * S] — word 0 the
    accumulator, 0; then address, words n, head words h, first tile a
    span — spans S, tiles). Spans of no words are left out. h = min(words
    to the next 16-byte boundary, n); the body of (n - h) >> 3 vectors is
    cut into tiles of TILE_VECS, at least one a span."""
    a = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
    addr, n = a[a[:, 1] > 0].T
    if (addr % 2).any():
        raise ValueError(f"span at {int(addr[addr % 2 > 0][0]):#x}: int16 "
                         "words must be 2-byte aligned")
    head = np.minimum((16 - addr % 16) % 16 // 2, n)
    tiles = np.maximum(1, -(-((n - head) >> 3) // TILE_VECS))
    first = np.cumsum(tiles) - tiles
    tab = np.zeros(1 + SPAN_WORDS * len(n), dtype=np.int64)
    tab[1:] = np.stack([addr, n, head, first], axis=1).reshape(-1)
    return tab, len(n), int(tiles.sum())


def row_spans(pcm: torch.Tensor, ng: np.ndarray) -> np.ndarray:
    """int64 [B, 2] (address, words) of each row's good prefix: row j of
    pcm int16 [B, nb, L] starts j*nb*L words in and counts ng[j]*L
    words."""
    B, nb, L = pcm.shape
    rows = np.arange(B, dtype=np.int64)
    return np.stack([pcm.data_ptr() + 2 * nb * L * rows,
                     good_rows(ng, nb) * L], axis=1)


def sum_all(pcms: Sequence[torch.Tensor],
            ngs: Sequence[np.ndarray]) -> torch.Tensor:
    """The masked sum of the chunks of ONE device, as a one-element int64
    tensor on that device whose value modulo 2^32 is the digest. CPU
    tensors take sum_all_plain; CUDA tensors launch the kernel (none when
    no row has a good block)."""
    pcms = list(pcms)
    ngs = list(ngs)
    if len(pcms) != len(ngs):
        raise ValueError(f"{len(pcms)} chunks, {len(ngs)} n_good arrays")
    if not pcms:
        raise ValueError("sum_all needs at least one chunk")
    dev = pcms[0].device
    if dev.type == "cpu":
        return sum_all_plain(pcms, ngs)
    if dev.type != "cuda":
        raise ValueError(f"no checksum kernel for device {dev}")
    spans = []
    for pcm, ng in zip(pcms, ngs):
        if pcm.device != dev:
            raise ValueError(f"chunks on {dev} and {pcm.device}: one "
                             "device a call")
        if pcm.dtype != torch.int16 or pcm.dim() != 3:
            raise ValueError(f"PCM must be int16 [B, nb, L], got "
                             f"{pcm.dtype} {tuple(pcm.shape)}")
        if not pcm.is_contiguous():
            raise ValueError("PCM must be contiguous")
        if np.shape(ng) != (pcm.shape[0],):
            raise ValueError(f"n_good must have {pcm.shape[0]} entries, got "
                             f"shape {np.shape(ng)}")
        spans.append(row_spans(pcm, ng))
    tab, nspans, tiles = plan(np.concatenate(spans))
    if not nspans:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    if nspans >= 1 << 31:
        raise ValueError(f"{nspans} spans: too many for one call")
    t = torch.from_numpy(tab).to(dev)
    launch(t, nspans, tiles)
    return t[:1]


def launch(table: torch.Tensor, nspans: int, tiles: int) -> None:
    """One launch of the kernel over a plan's table already on the card
    (its word 0 gathers the sum): CTAS_PER_SM CTAs a SM at most, on the
    current stream of the table's device."""
    lib = _load()
    dev = table.device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(tiles, CTAS_PER_SM * sms)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.acm_checksum(table.data_ptr(), nspans, tiles, grid, stream)
    if rc:
        raise RuntimeError(f"checksum_kernel launch failed: cudaError {rc}")
    launches.count("checksum")
