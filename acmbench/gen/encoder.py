"""ACM/WAVC encoder for the benchmark's data: a frozen copy of the fixture
encoder, the exact inverse of the filler grammar the decoder reads
(markokr/libacm src/decode.c:168-502). It encodes given coefficient
tensors (audio-like ones from `speech_blocks`); it is no production audio
encoder. `BitWriter.bitpos` (added to the copy) gives the bit offset of
every block it writes, so the block pool can cut blocks apart without a
scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..reference.format import ACM_ID

_MAP_1BIT = {-1: 0, +1: 1}
_MAP_2BIT_NEAR = {-2: 0, -1: 1, +1: 2, +2: 3}
_MAP_2BIT_FAR = {-3: 0, -2: 1, +2: 2, +3: 3}
_MAP_3BIT = {-4: 0, -3: 1, -2: 2, -1: 3, +1: 4, +2: 5, +3: 6, +4: 7}


class BitWriter:
    """LSB-first bit packer (inverse of the decoder's reservoir order)."""

    def __init__(self) -> None:
        self._out = bytearray()
        self._cur = 0
        self._nbits = 0

    def put(self, value: int, nbits: int) -> None:
        assert 0 <= value < (1 << nbits), (value, nbits)
        self._cur |= value << self._nbits
        self._nbits += nbits
        while self._nbits >= 8:
            self._out.append(self._cur & 0xFF)
            self._cur >>= 8
            self._nbits -= 8

    @property
    def bitpos(self) -> int:
        """Bits written so far."""
        return 8 * len(self._out) + self._nbits

    def getvalue(self) -> bytes:
        out = bytes(self._out)
        if self._nbits:
            out += bytes([self._cur & 0xFF])
        return out


# --------------------------------------------------------------------------
# Per-filler column encoders: emit the bit pattern that the corresponding
# decoder filler reads back into exactly `ks`.
# --------------------------------------------------------------------------


def _enc_linear(w: BitWriter, ks, ind: int) -> None:
    middle = 1 << (ind - 1)
    for k in ks:
        w.put(int(k) + middle, ind)


def _enc_pairzero(w: BitWriter, ks, emit_nonzero) -> None:
    """Shared shape of k13/k24/k35/k45: `0`→two zeros, `10`→one zero,
    `11…`→nonzero via emit_nonzero."""
    i, rows = 0, len(ks)
    while i < rows:
        if ks[i] == 0:
            if i + 1 >= rows or ks[i + 1] == 0:
                w.put(0, 1)
                i += 2
            else:
                w.put(0b01, 2)  # bits read LSB-first: 1 then 0
                i += 1
        else:
            w.put(0b11, 2)
            emit_nonzero(w, int(ks[i]))
            i += 1


def _enc_k13(w, ks):
    _enc_pairzero(w, ks, lambda w, k: w.put(_MAP_1BIT[k], 1))


def _enc_k12(w, ks):
    for k in ks:
        if k == 0:
            w.put(0, 1)
        else:
            w.put(1, 1)
            w.put(_MAP_1BIT[int(k)], 1)


def _enc_k24(w, ks):
    _enc_pairzero(w, ks, lambda w, k: w.put(_MAP_2BIT_NEAR[k], 2))


def _enc_k23(w, ks):
    for k in ks:
        if k == 0:
            w.put(0, 1)
        else:
            w.put(1, 1)
            w.put(_MAP_2BIT_NEAR[int(k)], 2)


def _enc_k35(w, ks):
    def nz(w, k):
        if k in _MAP_1BIT:
            w.put(0, 1)
            w.put(_MAP_1BIT[k], 1)
        else:
            w.put(1, 1)
            w.put(_MAP_2BIT_FAR[k], 2)

    _enc_pairzero(w, ks, nz)


def _enc_k34(w, ks):
    for k in ks:
        k = int(k)
        if k == 0:
            w.put(0, 1)
        elif k in _MAP_1BIT:
            w.put(0b01, 2)
            w.put(_MAP_1BIT[k], 1)
        else:
            w.put(0b11, 2)
            w.put(_MAP_2BIT_FAR[k], 2)


def _enc_k45(w, ks):
    _enc_pairzero(w, ks, lambda w, k: w.put(_MAP_3BIT[k], 3))


def _enc_k44(w, ks):
    for k in ks:
        if k == 0:
            w.put(0, 1)
        else:
            w.put(1, 1)
            w.put(_MAP_3BIT[int(k)], 3)


def _enc_t15(w, ks):
    i, rows = 0, len(ks)
    while i < rows:
        g = [int(ks[i + j]) if i + j < rows else 0 for j in range(3)]
        w.put((g[0] + 1) + 3 * (g[1] + 1) + 9 * (g[2] + 1), 5)
        i += 3


def _enc_t27(w, ks):
    i, rows = 0, len(ks)
    while i < rows:
        g = [int(ks[i + j]) if i + j < rows else 0 for j in range(3)]
        w.put((g[0] + 2) + 5 * (g[1] + 2) + 25 * (g[2] + 2), 7)
        i += 3


def _enc_t37(w, ks):
    i, rows = 0, len(ks)
    while i < rows:
        g = [int(ks[i + j]) if i + j < rows else 0 for j in range(2)]
        w.put((g[0] + 5) + 11 * (g[1] + 5), 7)
        i += 2


#: filler index → (encoder, (min_k, max_k)) for non-linear fillers.
_ENCODERS = {
    0: (lambda w, ks: None, (0, 0)),
    17: (_enc_k13, (-1, 1)),
    18: (_enc_k12, (-1, 1)),
    19: (_enc_t15, (-1, 1)),
    20: (_enc_k24, (-2, 2)),
    21: (_enc_k23, (-2, 2)),
    22: (_enc_t27, (-2, 2)),
    23: (_enc_k35, (-3, 3)),
    24: (_enc_k34, (-3, 3)),
    26: (_enc_k45, (-4, 4)),
    27: (_enc_k44, (-4, 4)),
    29: (_enc_t37, (-5, 5)),
}


def encode_column(w: BitWriter, ks, filler: int) -> None:
    """Emit one column: 5-bit filler code + the filler's payload."""
    w.put(filler, 5)
    if 3 <= filler <= 16:
        _enc_linear(w, ks, filler)
    else:
        _ENCODERS[filler][0](w, ks)


def choose_filler_best(ks) -> int:
    """Pick the cheapest filler for `ks` (bit-exact trial encodes).

    Real-world ACM files are near-entropy-coded (the 13 kbps anchor,
    libacm util.c:161-162), as real encoders choose.
    """
    lo, hi = int(np.min(ks)), int(np.max(ks))
    if lo == 0 and hi == 0:
        return 0
    cands = [f for f, (_, (flo, fhi)) in _ENCODERS.items()
             if f != 0 and flo <= lo and hi <= fhi]
    for ind in range(3, 17):
        if -(1 << (ind - 1)) <= lo and hi <= (1 << (ind - 1)) - 1:
            cands.append(ind)
            break
    best, best_bits = None, None
    for f in cands:
        w = BitWriter()
        encode_column(w, ks, f)
        bits = len(w._out) * 8 + w._nbits
        if best_bits is None or bits < best_bits:
            best, best_bits = f, bits
    if best is None:
        raise ValueError(f"coefficients out of range: [{lo}, {hi}]")
    return best


@dataclasses.dataclass
class BlockData:
    pwr: int  # 4-bit; legal k range is [-2**pwr, 2**pwr - 1]
    val: int  # 16-bit amplitude step
    k: np.ndarray  # int[rows, cols] coefficient indices


def write_header(
    w: BitWriter,
    total_values: int,
    channels: int,
    rate: int,
    level: int,
    rows: int,
) -> None:
    w.put(ACM_ID, 24)
    w.put(1, 8)  # version
    w.put(total_values & 0xFFFF, 16)
    w.put((total_values >> 16) & 0xFFFF, 16)
    w.put(channels, 16)
    w.put(rate, 16)
    w.put(level, 4)
    w.put(rows, 12)


def wavc_wrap(acm_bytes: bytes, raw_size: int | None = None) -> bytes:
    """Prepend the 28-byte WAVC wrapper (decode.c:687-710 checks 'WAVC',
    'V1.0' and word[6]==28; sizes are unchecked)."""
    if raw_size is None:
        raw_size = 0
    w = BitWriter()
    for ch in b"WAVC":
        w.put(ch, 8)
    words = [0x3156, 0x302E, raw_size & 0xFFFF, raw_size >> 16,
             len(acm_bytes) & 0xFFFF, len(acm_bytes) >> 16,
             28, 0, 1, 16, 22050, 0]
    for v in words:
        w.put(v, 16)
    return w.getvalue() + acm_bytes
