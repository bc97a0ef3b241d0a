"""PyTorch synthesis back-end: dequantize + subband filterbank + PCM format.

Counterpart of `libacm_tpu/ops/synth_jax.py`, written as plain tensor ops.
Each of the log2(cols) passes is an order-2 FIR over its *raw* inputs,

    y[n] = s[n] + 2*s[n-1] + s[n-2]     (n even)
    y[n] = 2*s[n-1] - s[n-2] - s[n]     (n odd)

on the pass-p view (rows<<(p+1), cols>>(p+1)) of each flat block; s[-2],
s[-1] come from the previous block's pass-p input, or from the pass's
segment of the stream carry `wrap0` (2*cols-2 ints, the reference wrapbuf
layout) at block 0. After pass 0 only, +1 is added to element 0 of every
pass-0 row; level 0 has no pass and no bias. Because every pass reads raw
inputs, all blocks of all files run each pass at once: there is no serial
scan over blocks.

All arithmetic is int32 with two's-complement wraparound (torch wraps
int32 add and mul) and the final `>> level` is arithmetic, followed by
truncation to int16 — the format's bit-exact contract.

These functions are the plain version of the CUDA kernel in
`ops/synth_cuda.py`: the CPU path, and the yardstick the kernel is held to
on the card. The file axis is a leading batch dimension, never a vmap.
"""

from __future__ import annotations

import numpy as np
import torch


def _wrap_layout(level: int, cols: int) -> list[tuple[int, int, int]]:
    """Static per-pass geometry: (wrap_offset, sub_len, sub_count_factor).

    Pass p's wrap segment has length 2*sub_len; segments are laid out
    consecutively (total 2*cols-2).
    """
    out = []
    off = 0
    for p in range(level):
        sub_len = cols >> (p + 1)
        out.append((off, sub_len, 1 << (p + 1)))
        off += 2 * sub_len
    return out


def _signs(cnt: int, device) -> torch.Tensor:
    """FIR sign pattern down a pass row axis: +1 even rows, -1 odd rows."""
    return torch.from_numpy(
        np.where((np.arange(cnt) & 1) == 0, 1, -1).astype(np.int32)
    ).to(device)


def synth_words_batch(
    k: torch.Tensor,  # int16/int32 [B, nb, rows, cols] coefficient indices
    vals: torch.Tensor,  # int32 [B, nb] per-block amplitude step
    wrap0: torch.Tensor,  # int32 [B, 2*cols-2] initial carry per file
    *,
    level: int,
    rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All blocks of B streams, every pass parallel over blocks and files.

    Returns (words int32 [B, nb, rows*cols] pre-shift, final carry
    [B, 2*cols-2]).
    """
    cols = 1 << level
    n = rows * cols
    B, nb = k.shape[0], k.shape[1]
    if nb == 0:
        return torch.zeros((B, 0, n), dtype=torch.int32,
                           device=k.device), wrap0
    x = (k.to(torch.int32) * vals.to(torch.int32)[:, :, None, None]
         ).reshape(B, nb, n)
    segs = []
    for p, (off, sub_len, f) in enumerate(_wrap_layout(level, cols)):
        cnt = rows * f
        mat = x.reshape(B, nb, cnt, sub_len)
        # carry for block i = last two raw rows of block i-1's pass-p input;
        # block 0 takes the stream carry's pass-p segment (wrapbuf semantics)
        seg0 = wrap0[:, off : off + 2 * sub_len].reshape(B, 1, 2, sub_len)
        prev = torch.cat([seg0.to(torch.int32), mat[:, :-1, -2:, :]], dim=1)
        s = torch.cat([prev, mat], dim=2)  # [B, nb, cnt+2, sub_len]
        y = (_signs(cnt, k.device)[None, None, :, None]
             * (s[:, :, 2:] + s[:, :, :-2]) + 2 * s[:, :, 1:-1])
        if p == 0:
            y[:, :, :, 0] += 1  # rounding bias (decode.c:561-565)
        segs.append(mat[:, -1, -2:, :].reshape(B, -1))
        x = y.reshape(B, nb, n)
    wrap_f = torch.cat(segs, dim=1) if segs else wrap0
    return x, wrap_f


def synth_words(
    k: torch.Tensor,  # [nb, rows, cols]
    vals: torch.Tensor,  # [nb]
    wrap0: torch.Tensor,  # [2*cols-2]
    *,
    level: int,
    rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One stream: (words int32 [nb, rows*cols] pre-shift, final carry)."""
    words, wrap_f = synth_words_batch(k[None], vals[None], wrap0[None],
                                      level=level, rows=rows)
    return words[0], wrap_f[0]


def words_to_pcm(words: torch.Tensor, *, level: int) -> torch.Tensor:
    """int32 words → int16 samples (arithmetic >> level, low 16 bits)."""
    return (words >> level).to(torch.int16)


def synth_pcm(
    k: torch.Tensor, vals: torch.Tensor, wrap0: torch.Tensor, *, level: int,
    rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One stream, fused synth + PCM: int16 [nb, rows*cols] + final carry."""
    words, wrap_f = synth_words(k, vals, wrap0, level=level, rows=rows)
    return words_to_pcm(words, level=level), wrap_f


def synth_pcm_batch(
    k: torch.Tensor,  # [B, nb, rows, cols]
    vals: torch.Tensor,  # [B, nb]
    wrap0: torch.Tensor,  # [B, 2*cols-2]
    *,
    level: int,
    rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched corpora: (pcm int16 [B, nb, rows*cols], wrap_f [B, 2cols-2])."""
    words, wrap_f = synth_words_batch(k, vals, wrap0, level=level, rows=rows)
    return words_to_pcm(words, level=level), wrap_f


def warmup_blocks(level: int, rows: int) -> int:
    """Blocks to synthesize from a zero carry before a block whose true
    carry-in is unknown: W = ceil((2*cols - 2) / (rows*cols)).

    Pass p's zero halo pollutes its output from the start of the first
    warm-up block up to sum_{q<=p} 2*s_q, so pass p's input is polluted up
    to 2*cols - 4*s_p, while the carry of pass p is the last 2*s_p inputs
    of the last warm-up block. W blocks of rows*cols elements leave every
    pass's carry clean iff W*rows*cols >= 2*cols - 2*s_p for every p, and
    the last pass (s = 1) sets W. So W is 1 for rows >= 2, 1 at level 1,
    2 for rows == 1 from level 2 (where one block leaves pass 1's carry
    wrong), and 0 at level 0 (no carry). The fused CUDA kernel and
    carry_of_block rest on it.
    """
    cols = 1 << level
    return -(-(2 * cols - 2) // (rows * cols))


def carry_of_block(
    k: torch.Tensor,  # int16/int32 [W, rows, cols] or [rows, cols]
    val: torch.Tensor,  # int32 [W] or scalar
    *,
    level: int,
    rows: int,
) -> torch.Tensor:
    """Exact wrap carry left behind by the last of W consecutive blocks,
    from those W blocks alone, W = warmup_blocks(level, rows).

    The incoming carry pollutes only the first 2*cols-2 outputs of the
    last pass counted from the first block, while the outgoing carry is
    the tail 2*sub_len elements of each pass *input* of the last block —
    the regions never overlap once W*rows*cols >= 2*cols - 2. So
    synthesizing those blocks from a zero carry yields the true carry
    state. For rows >= 2 one block is enough, and a single block may be
    given as [rows, cols] with a scalar val. Callers must give W blocks.
    The fused CUDA kernel rests on the same fact: each span first
    synthesizes the W blocks before it from a zero carry.
    """
    cols = 1 << level
    wrap0 = torch.zeros(max(2 * cols - 2, 1), dtype=torch.int32,
                        device=k.device)
    k = k.reshape(-1, rows, cols)
    _, wrap = synth_words(k, val.reshape(-1), wrap0, level=level, rows=rows)
    return wrap


def synthesize(k, vals, wrap0, *, level: int, rows: int, backend: str):
    """Run the filterbank: backend "torch" is the plain version, "cuda"
    the kernel wrapper (which takes the plain version for CPU tensors)."""
    if backend == "cuda":
        from .synth_cuda import synth_pcm_batch as kernel_fn

        return kernel_fn(k, vals, wrap0, level=level, rows=rows)
    if backend != "torch":
        raise ValueError(f"unknown synthesis backend {backend!r}")
    return synth_pcm_batch(k, vals, wrap0, level=level, rows=rows)


def synth_pcm_packed(
    p4: torch.Tensor, p8: torch.Tensor, p16: torch.Tensor,
    idx4: torch.Tensor, idx8: torch.Tensor, idx16: torch.Tensor,
    vals: torch.Tensor,  # [batch, nb]
    wrap0: torch.Tensor,  # [batch, 2*cols-2]
    *,
    level: int,
    rows: int,
    batch: int,
    nb: int,
    backend: str = "torch",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched synth from per-block width-class packed coefficients
    (see ops.packing.pack_blocks); unpacked on the tensors' device."""
    from .packing import unpack_blocks

    cols = 1 << level
    k = unpack_blocks(
        p4, p8, p16, idx4, idx8, idx16, nb=batch * nb, rows=rows, cols=cols
    ).reshape(batch, nb, rows, cols)
    return synthesize(k, vals, wrap0, level=level, rows=rows, backend=backend)


def unpack_cols(
    cls: torch.Tensor,  # uint8 [batch, nb, ceil(cols/4)] 2-bit class codes
    pay4: torch.Tensor, pay8: torch.Tensor, pay16: torch.Tensor,
    wid4: torch.Tensor, wid8: torch.Tensor, wid16: torch.Tensor,
    *,
    level: int,
    rows: int,
    batch: int,
    nb: int,
) -> torch.Tensor:
    """Coefficients int16 [batch, nb, rows, cols] from the exact-width
    per-column wire (scanner v2): ops.packing.unpack_columns as tensor ops
    on the wire's device. With _bytes_le, the plain version of the CUDA
    unpack kernel (ops/unpack_cuda.py, through unpack_cols_blob_plain)."""
    from .packing import unpack_columns

    cols = 1 << level
    shifts = torch.arange(4, dtype=torch.int32, device=cls.device) * 2
    codes = (cls.to(torch.int32)[..., None] >> shifts) & 3
    codes = codes.reshape(batch, nb, -1)[..., :cols]
    k_cols = unpack_columns(
        codes.reshape(batch * nb * cols), pay4, pay8, pay16,
        wid4, wid8, wid16, rows=rows,
    )  # [batch*nb*cols, rows]
    k = k_cols.reshape(batch, nb, cols, rows).permute(0, 1, 3, 2)
    return k.contiguous()


def synth_pcm_cols(
    cls: torch.Tensor,  # uint8 [batch, nb, ceil(cols/4)] 2-bit class codes
    pay4: torch.Tensor, pay8: torch.Tensor, pay16: torch.Tensor,
    wid4: torch.Tensor, wid8: torch.Tensor, wid16: torch.Tensor,
    vals: torch.Tensor,  # [batch, nb]
    wrap0: torch.Tensor,  # [batch, 2*cols-2]
    *,
    level: int,
    rows: int,
    batch: int,
    nb: int,
    backend: str = "torch",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched synth from the exact-width per-column wire: unpack_cols,
    then the filterbank — the plain version (backend="torch") or the CUDA
    kernel (backend="cuda")."""
    k = unpack_cols(cls, pay4, pay8, pay16, wid4, wid8, wid16,
                    level=level, rows=rows, batch=batch, nb=nb)
    return synthesize(k, vals, wrap0, level=level, rows=rows, backend=backend)


def cols_blob_layout(level: int, batch: int, nb: int,
                     lens: tuple[int, int, int, int, int, int],
                     has_wrap: bool = True):
    """Byte offsets of each wire section inside the coalesced blob.

    Returns ([(off, size) per section in synth_pcm_cols arg order],
    total). has_wrap=False omits the trailing wrap0 section.
    """
    cols = 1 << level
    stride = (cols + 3) // 4
    wlen = 2 * cols - 2
    l4, l8, l16, lw4, lw8, lw16 = lens
    sizes = [batch * nb * stride, l4, l8, l16, lw4, lw8, lw16,
             2 * batch * nb]
    if has_wrap:
        sizes.append(4 * batch * wlen)
    out, off = [], 0
    for sz in sizes:
        out.append((off, sz))
        off += sz
    return out, off


def _bytes_le(b: torch.Tensor, n: int) -> torch.Tensor:
    """Little-endian n-byte integers from a flat uint8 tensor, as int32.

    Byte math rather than a dtype view: explicit endianness, and no
    alignment constraint on the blob slice. 4-byte values keep their
    two's-complement bit pattern (int32), 2-byte values are unsigned.
    Part of the CUDA unpack kernel's plain version (unpack_cols_blob_plain).
    """
    parts = b.reshape(-1, n).to(torch.int64)
    u = parts[:, 0]
    for i in range(1, n):
        u = u | (parts[:, i] << (8 * i))
    if n == 4:
        u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32)


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
    """(k int16 [batch, nb, rows, cols], vals int32 [batch, nb], the
    blob's wrap0 int32 [batch, 2*cols-2] or None) from ONE coalesced wire
    blob, by the blob's device: the CUDA unpack kernel on a card
    (ops/unpack_cuda.py, which launches or raises), the plain version
    (unpack_cols_blob_plain) on the CPU; any other device raises."""
    from .unpack_cuda import unpack_cols_blob as kernel_fn

    return kernel_fn(blob, level=level, rows=rows, batch=batch, nb=nb,
                     lens=lens, has_wrap=has_wrap)


def unpack_cols_blob_plain(
    blob: torch.Tensor,  # uint8 [total]: all wire sections coalesced
    *,
    level: int,
    rows: int,
    batch: int,
    nb: int,
    lens: tuple[int, int, int, int, int, int],
    has_wrap: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """unpack_cols_blob as tensor ops on the blob's device: the plain
    version the CUDA unpack kernel is held to. The sections are sliced at
    the offsets of cols_blob_layout; vals (uint16) and wrap0 (int32) are
    reassembled from little-endian bytes."""
    cols = 1 << level
    secs, total = cols_blob_layout(level, batch, nb, lens, has_wrap=has_wrap)
    if tuple(blob.shape) != (total,):
        raise ValueError(f"wire blob has shape {tuple(blob.shape)}, "
                         f"layout needs ({total},)")
    parts = [blob[o : o + n] for o, n in secs]
    k = unpack_cols(parts[0].reshape(batch, nb, (cols + 3) // 4),
                    *parts[1:7], level=level, rows=rows, batch=batch, nb=nb)
    vals = _bytes_le(parts[7], 2).reshape(batch, nb)
    wrap0 = (_bytes_le(parts[8], 4).reshape(batch, 2 * cols - 2)
             if has_wrap else None)
    return k, vals, wrap0


def synth_pcm_cols_blob(
    blob: torch.Tensor,  # uint8 [total]: all wire sections coalesced
    wrap0: torch.Tensor | None = None,  # int32 [batch, 2*cols-2] carry-in
    *,
    level: int,
    rows: int,
    batch: int,
    nb: int,
    backend: str = "torch",
    lens: tuple[int, int, int, int, int, int] = (),
) -> tuple[torch.Tensor, torch.Tensor]:
    """synth_pcm_cols over ONE coalesced uint8 wire blob.

    The host packs a chunk's whole wire into a single buffer so it crosses
    to the device in one copy; the sections are sliced back out here
    (unpack_cols_blob: the CUDA unpack kernel on a card, its plain version
    on the CPU). `backend` picks the filterbank (synthesize). An explicit
    wrap0 tensor replaces the blob's wrap section, which must then be
    absent.
    """
    k, vals, blob_wrap = unpack_cols_blob(
        blob, level=level, rows=rows, batch=batch, nb=nb, lens=lens,
        has_wrap=wrap0 is None)
    return synthesize(k, vals, blob_wrap if wrap0 is None else wrap0,
                      level=level, rows=rows, backend=backend)


def decode_scan_result(scan, backend: str | None = None,
                       device=None) -> np.ndarray:
    """Host wrapper: ScanResult → int16 PCM words (numpy, unclamped).

    Output covers the scanned blocks only; callers apply total_values /
    channel clamping (stream layer). backend=None synthesizes on `device`
    (None: the card, see device.resolve_device) through the kernel
    wrapper — the CUDA kernel on a card, its plain version on the CPU —
    and fetches; backend="host" asks for the native host synth and raises
    without it. A stale-amp-table stream (scan.n_exceptions) always takes
    the oracle: only its virtual table reproduces the reference exactly.
    """
    if backend not in (None, "host"):
        raise ValueError(f"unknown synthesis backend {backend!r} (None "
                         "synthesizes on the device, 'host' on the CPU)")
    h = scan.header
    nb = scan.n_blocks
    if nb == 0:
        return np.zeros(0, dtype=np.int16)
    if scan.n_exceptions:
        from ..scan import oracle as _oracle

        return _oracle.words_to_pcm(_oracle.synth_all(scan), h.level)
    if backend == "host":
        from ..scan import native as _native

        if not _native.available():
            raise RuntimeError("native host synth unavailable")
        pcm, _ = _native.synth_dense(scan.k, scan.val, h.level, h.rows)
        return pcm.reshape(-1)
    from ..device import resolve_device

    dev = resolve_device(device)
    k = torch.from_numpy(np.ascontiguousarray(scan.k[:nb])).to(dev)
    vals = torch.from_numpy(scan.val[:nb].astype(np.int32)).to(dev)
    # the carry has h.wrapbuf_len words: none at level 0
    wrap0 = torch.zeros((1, h.wrapbuf_len), dtype=torch.int32, device=dev)
    pcm, _ = synthesize(k[None], vals[None], wrap0, level=h.level,
                        rows=h.rows, backend="cuda")
    return pcm[0].cpu().numpy().reshape(-1)
