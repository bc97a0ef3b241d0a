"""Wire-format packing of coefficient tensors (host pack → device unpack).

Counterpart of `libacm_tpu/ops/packing.py`. Two wire formats:

- per-block width classes (`pack_blocks` on the host in NumPy,
  `unpack_blocks` on the device): each block ships as 4-bit nibbles,
  int8 or int16 by its observed coefficient range;
- the scanner's exact-width per-column wire (`unpack_columns`): each
  nonzero column is rows*w bits at its filler's width, in three
  class-family bit streams plus width nibbles and a 2-bit class map.

The unpack functions run on the wire's device; their results are
bit-identical to the dense coefficients. On a card the per-column wire is
unpacked by the CUDA kernel of `ops/unpack_cuda.py` (`csrc/unpack.cu`),
and `unpack_blocks` launches the one of `ops/unpack_blocks_cuda.py`
(`csrc/unpack_blocks.cu`). `unpack_columns` and `unpack_blocks_plain` are
their plain versions, which the CPU runs and the tests and `chip_smoke.py`
hold the kernels to.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PackedBlocks:
    """Host-side packed coefficients for one [nb, rows, cols] tensor.

    Block order is preserved via the idx arrays: block `idx4[i]` is the
    i-th 4-bit-packed block, etc. Every block belongs to exactly one class.
    Payloads may be padded on the block axis; idx entries for padding
    point at dummy slot nb (dropped after the scatter).
    """

    nb: int
    rows: int
    cols: int
    p4: np.ndarray  # int8 [n4p, ceil(block_len/2)] two nibbles per byte
    p8: np.ndarray  # int8 [n8p, block_len]
    p16: np.ndarray  # int16 [n16p, block_len]
    idx4: np.ndarray  # int32 [n4p]
    idx8: np.ndarray  # int32 [n8p]
    idx16: np.ndarray  # int32 [n16p]

    @property
    def wire_bytes(self) -> int:
        return (self.p4.nbytes + self.p8.nbytes + self.p16.nbytes
                + self.idx4.nbytes + self.idx8.nbytes + self.idx16.nbytes)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def pack_blocks(k: np.ndarray, pad_to: tuple[int, int, int] | None = None) -> PackedBlocks:
    """Pack [nb, rows, cols] int16 coefficients into width classes.

    `pad_to` pads the three class counts (for shared shapes).
    """
    nb, rows, cols = k.shape
    n = rows * cols
    flat = k.reshape(nb, n)
    if nb:
        mx = np.max(flat, axis=1)
        mn = np.min(flat, axis=1)
        is4 = (mx <= 7) & (mn >= -8)
        is8 = ~is4 & (mx <= 127) & (mn >= -128)
    else:
        is4 = is8 = np.zeros(0, dtype=bool)
    is16 = ~(is4 | is8)

    idx4 = np.nonzero(is4)[0].astype(np.int32)
    idx8 = np.nonzero(is8)[0].astype(np.int32)
    idx16 = np.nonzero(is16)[0].astype(np.int32)

    f4 = flat[idx4]
    if n % 2:
        f4 = np.concatenate([f4, np.zeros((len(idx4), 1), np.int16)], axis=1)
    p4 = ((f4[:, 0::2] & 0xF) | ((f4[:, 1::2] & 0xF) << 4)).astype(np.int8)
    p8 = flat[idx8].astype(np.int8)
    p16 = flat[idx16]

    if pad_to is not None:
        n4p, n8p, n16p = pad_to
        # padding index entries target the scratch slot `nb`
        idx4 = _pad_rows(idx4, n4p) + np.where(np.arange(n4p) >= len(p4), nb, 0).astype(np.int32)
        idx8 = _pad_rows(idx8, n8p) + np.where(np.arange(n8p) >= len(p8), nb, 0).astype(np.int32)
        idx16 = _pad_rows(idx16, n16p) + np.where(np.arange(n16p) >= len(p16), nb, 0).astype(np.int32)
        p4 = _pad_rows(p4, n4p)
        p8 = _pad_rows(p8, n8p)
        p16 = _pad_rows(p16, n16p)

    return PackedBlocks(nb=nb, rows=rows, cols=cols, p4=p4, p8=p8, p16=p16,
                        idx4=idx4, idx8=idx8, idx16=idx16)


def class_counts(k: np.ndarray) -> tuple[int, int, int]:
    """(n4, n8, n16) without building payloads (for shared pad shapes)."""
    nb = k.shape[0]
    if nb == 0:
        return 0, 0, 0
    flat = k.reshape(nb, -1)
    mx = np.max(flat, axis=1)
    mn = np.min(flat, axis=1)
    is4 = (mx <= 7) & (mn >= -8)
    is8 = ~is4 & (mx <= 127) & (mn >= -128)
    n4 = int(is4.sum())
    n8 = int(is8.sum())
    return n4, n8, nb - n4 - n8


def unpack_columns(
    cls_flat: torch.Tensor,  # integer [N] class codes in scan order
    pay4: torch.Tensor,  # uint8 bit stream (class-1 columns)
    pay8: torch.Tensor,  # uint8 bit stream (class-2)
    pay16: torch.Tensor,  # uint8 bit stream (class-3)
    wid4: torch.Tensor, wid8: torch.Tensor, wid16: torch.Tensor,  # nibbles
    *,
    rows: int,
) -> torch.Tensor:
    """Exact-width per-column wire (v2) → int16 [N, rows] columns.

    Per class family: each nonzero column's width comes from its nibble
    stream (w-1 at the column's class ordinal), its bit offset from an
    exclusive cumsum of rows*w in scan order, and each value from a
    window of two little-endian uint16 words of the bit stream:

        v = ((u16[bit>>4] | u16[(bit>>4)+1] << 16) >> (bit & 15)) & mask

    (bit&15) + w <= 31, so the 32-bit window always covers the value.
    Offsets are int64 here, so no stream length limit applies. The plain
    version of the CUDA unpack kernel (ops/unpack_cuda.py), which computes
    the same ordinals, widths, offsets and clamped word reads.
    """
    dev = cls_flat.device
    n = cls_flat.shape[0]
    k = torch.zeros((n, rows), dtype=torch.int16, device=dev)
    r = torch.arange(rows, dtype=torch.int64, device=dev)[None, :]
    for code, pay, wid in ((1, pay4, wid4), (2, pay8, wid8),
                           (3, pay16, wid16)):
        if pay.shape[0] < 2 or wid.shape[0] == 0:
            continue  # class family has no columns
        m = cls_flat == code
        ordinal = torch.cumsum(m.to(torch.int64), 0) - 1  # class ordinal
        oc = ordinal.clamp(min=0)
        wb = wid.to(torch.int64)[(oc >> 1).clamp(0, wid.shape[0] - 1)]
        wn = (wb >> ((oc & 1) * 4)) & 0xF
        w = torch.where(m, wn + 1, 0)
        colbits = w * rows
        off = torch.cumsum(colbits, 0) - colbits  # exclusive
        bit = off[:, None] + r * w[:, None]  # [N, rows]
        pb = pay.to(torch.int64)
        h = pb[0::2] | (pb[1::2] << 8)  # little-endian uint16 words
        i0 = (bit >> 4).clamp(0, h.shape[0] - 1)
        i1 = ((bit >> 4) + 1).clamp(0, h.shape[0] - 1)
        window = h[i0] | (h[i1] << 16)
        wv = w.clamp(min=1)[:, None]  # avoid shift-by--1 on zero cols
        v = (window >> (bit & 15)) & ((1 << wv) - 1)
        sign = 1 << (wv - 1)
        v = (v ^ sign) - sign
        k = torch.where(m[:, None], v.to(torch.int16), k)
    return k


def unpack_blocks(
    p4: torch.Tensor, p8: torch.Tensor, p16: torch.Tensor,
    idx4: torch.Tensor, idx8: torch.Tensor, idx16: torch.Tensor,
    *, nb: int, rows: int, cols: int,
) -> torch.Tensor:
    """Device-side inverse of pack_blocks → int16 [nb, rows, cols]. CPU
    tensors take unpack_blocks_plain; CUDA tensors launch the kernel of
    ops/unpack_blocks_cuda.py (csrc/unpack_blocks.cu) or raise."""
    dev = p16.device
    if dev.type == "cpu":
        return unpack_blocks_plain(p4, p8, p16, idx4, idx8, idx16, nb=nb,
                                   rows=rows, cols=cols)
    if dev.type != "cuda":
        raise ValueError(f"no unpack_blocks kernel for device {dev}")
    from .unpack_blocks_cuda import unpack_blocks as kernel_fn

    return kernel_fn(p4, p8, p16, idx4, idx8, idx16, nb=nb, rows=rows,
                     cols=cols)


def unpack_blocks_plain(
    p4: torch.Tensor, p8: torch.Tensor, p16: torch.Tensor,
    idx4: torch.Tensor, idx8: torch.Tensor, idx16: torch.Tensor,
    *, nb: int, rows: int, cols: int,
) -> torch.Tensor:
    """unpack_blocks as torch ops (the plain version of the kernel):
    nibbles sign-extended by arithmetic shifts, three scatters (4-bit,
    8-bit, 16-bit, so a later class wins a block two name) into a zeroed
    [nb + 1, n] whose row nb takes the padding. Indices follow the JAX
    package's rules: an idx below 0 names block idx + nb + 1, and one
    whose block lies outside [0, nb] goes to row nb too, so it names
    none. Two rows of one class naming one block are outside the
    contract (the order of their writes is open, as in JAX)."""
    n = rows * cols
    # nibbles → int16 with sign extension via arithmetic shifts
    lo = (p4.to(torch.int16) << 12) >> 12
    hi = p4.to(torch.int16) >> 4
    f4 = torch.stack([lo, hi], dim=-1).reshape(p4.shape[0],
                                               2 * p4.shape[1])[:, :n]
    out = torch.zeros((nb + 1, n), dtype=torch.int16, device=p16.device)
    for idx, vals in ((idx4, f4), (idx8, p8), (idx16, p16)):
        i = idx.long()
        i = torch.where(i < 0, i + nb + 1, i)
        out[torch.where((i >= 0) & (i <= nb), i, nb)] = vals.to(torch.int16)
    return out[:nb].reshape(nb, rows, cols)
