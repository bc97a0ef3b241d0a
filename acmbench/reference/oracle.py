"""The plain reference of the ACM bitstream: a frozen NumPy copy of the
decoder's executable specification, kept apart from the program under
test.

It models the C reference decoder (markokr/libacm, src/decode.c) exactly:
the 32-bit LSB-first bit reservoir and its byte accounting (decode.c:41-163),
the EOF zero-byte quirk (decode.c:57-61), the 32-entry filler grammar
(decode.c:168-502), the multi-pass integer synthesis filterbank
(decode.c:508-577) and the error taxonomy. It is simple and slow. The scanner
emits dense per-block coefficient indices k with per-block (pwr, val); the
dequantization k*val, the filterbank, the rounding bias, the >> level shift
and the int16 truncation follow in synthesis.

Beside the copy: `BitReader.at_bit`, a reader placed at a block boundary
with the reservoir state a scan from the stream start has there, so that a
scan can resume mid-stream (acmbench.reference.decode uses it).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .format import (
    ACM_ID,
    ACM_EXPECTED_EOF,
    AcmError,
    AcmHeader,
    WAVC_ID,
)

# Coefficient lookup maps (decode.c:168-171).
_MAP_1BIT = (-1, +1)
_MAP_2BIT_NEAR = (-2, -1, +1, +2)
_MAP_2BIT_FAR = (-3, -2, +2, +3)
_MAP_3BIT = (-4, -3, -2, -1, +1, +2, +3, +4)


class BitsExhausted(Exception):
    """Raised when a bit read crosses the end of (file + 1 zero byte)."""


class BitReader:
    """Exact model of the reference's 32-bit LSB-first reservoir.

    Semantics reproduced (decode.c:41-163):
      - bits come LSB-first from a little-endian byte stream;
      - on EOF exactly one zero byte is appended so trailing bits decode;
      - the reservoir is topped up in 32-bit (4-byte) reloads, truncated at
        stream end; a read that still cannot be satisfied after one reload
        fails (maps to UNEXPECTED_EOF at the call site);
      - ``loaded_bytes`` tracks how many stream bytes (incl. the phantom
        zero byte) have been pulled into the reservoir — this is what
        ``acm_raw_tell`` observes (buf_start_ofs + buf_pos, util.c:192-195).
    """

    def __init__(self, data: bytes):
        self._data = data
        # Effective stream: file bytes + one zero byte (decode.c:57-61).
        self._total_bits = 8 * (len(data) + 1)
        self._loaded_bits = 0
        self._res = 0  # reservoir value (LSB = next bit)
        self._avail = 0

    @classmethod
    def at_bit(cls, data: bytes, bit: int) -> "BitReader":
        """A reader placed at absolute bit `bit` of the stream, holding the
        reservoir that a reader which consumed exactly `bit` bits by
        successful reads from bit 0 holds there. Reloads take 32-bit words
        from bit 0 and, after any successful read, fewer than 32 loaded bits
        are unread; so the loaded count is the first multiple of 32 at or
        past `bit`, or the stream's end where that is nearer."""
        r = cls(data)
        loaded = min(-(-bit // 32) * 32, r._total_bits)
        padded = bytes(data) + b"\x00" * 8
        word = int.from_bytes(padded[bit // 8 : -(-loaded // 8)], "little")
        r._loaded_bits = loaded
        r._avail = loaded - bit
        r._res = (word >> (bit % 8)) & ((1 << r._avail) - 1)
        return r

    @property
    def loaded_bytes(self) -> int:
        return self._loaded_bits // 8

    @property
    def consumed_bits(self) -> int:
        """Bits taken by reads so far (loaded, less those still unread)."""
        return self._loaded_bits - self._avail

    def get(self, n: int) -> int:
        """Read n (<= 31) bits; raises BitsExhausted if the stream ends.

        Failure path matches the C exactly (get_bits_reload,
        decode.c:108-135): the previously available bits are *dropped* and
        the reservoir keeps only the freshly reloaded bits — subsequent
        reads (the reference's keep-trying-after-error behavior) see the
        same bit positions the C would.
        """
        if self._avail >= n:
            val = self._res & ((1 << n) - 1)
            self._res >>= n
            self._avail -= n
            return val
        # reload: top up with one (up to) 32-bit word from the stream
        need = n - self._avail
        take = min(32, self._total_bits - self._loaded_bits)
        start = self._loaded_bits // 8
        word = 0
        for i in range(take // 8):
            pos = start + i
            byte = self._data[pos] if pos < len(self._data) else 0
            word |= byte << (8 * i)
        self._loaded_bits += take
        if take < need:
            self._res, self._avail = word, take
            raise BitsExhausted()
        val = self._res | ((word & ((1 << need) - 1)) << self._avail)
        self._res = word >> need
        self._avail = take - need
        return val


def parse_header(bits: BitReader) -> AcmHeader | None:
    """Parse ACM / WAVC header (decode.c:687-752). None ⇒ not an ACM file."""
    try:
        magic = bits.get(24)
        wavc = False
        if magic == WAVC_ID:
            if bits.get(8) != ord("C"):
                return None
            words = [bits.get(16) for _ in range(12)]
            # 'V1.0' check + the magic 28 at word 6; the rest is ignored
            # (read_wavc_header, decode.c:687-710 — the strict comparison
            # there is dead code behind `if (0 && ...)`).
            if words[0] != 0x3156 or words[1] != 0x302E:
                return None
            if words[6] != 28:
                return None
            wavc = True
            magic = bits.get(24)
        if magic != ACM_ID:
            return None
        if bits.get(8) != 1:  # version
            return None
        total_values = bits.get(16) | (bits.get(16) << 16)
        if total_values == 0:
            return None
        channels = bits.get(16)
        if channels < 1 or channels > 2:
            return None
        rate = bits.get(16)
        if rate < 4096:
            return None
        level = bits.get(4)
        rows = bits.get(12)
        if rows == 0:
            return None
        return AcmHeader(
            total_values=total_values,
            channels=channels,
            rate=rate,
            level=level,
            rows=rows,
            wavc_file=wavc,
        )
    except BitsExhausted:
        return None


# ---------------------------------------------------------------------------
# Filler grammar (decode.c:168-502): per column, a 5-bit code selects how the
# column's `rows` coefficient indices are encoded.
# ---------------------------------------------------------------------------


class CorruptStream(Exception):
    pass


def _f_linear(ind, bits, rows, col):
    middle = 1 << (ind - 1)
    for i in range(rows):
        col[i] = bits.get(ind) - middle


def _f_k13(ind, bits, rows, col):
    i = 0
    while i < rows:
        if bits.get(1) == 0:  # `0` → two zeros
            i += 2
            continue
        if bits.get(1) == 0:  # `10` → one zero
            i += 1
            continue
        col[i] = _MAP_1BIT[bits.get(1)]  # `11x`
        i += 1


def _f_k12(ind, bits, rows, col):
    for i in range(rows):
        if bits.get(1):
            col[i] = _MAP_1BIT[bits.get(1)]


def _f_k24(ind, bits, rows, col):
    i = 0
    while i < rows:
        if bits.get(1) == 0:
            i += 2
            continue
        if bits.get(1) == 0:
            i += 1
            continue
        col[i] = _MAP_2BIT_NEAR[bits.get(2)]
        i += 1


def _f_k23(ind, bits, rows, col):
    for i in range(rows):
        if bits.get(1):
            col[i] = _MAP_2BIT_NEAR[bits.get(2)]


def _f_k35(ind, bits, rows, col):
    i = 0
    while i < rows:
        if bits.get(1) == 0:
            i += 2
            continue
        if bits.get(1) == 0:
            i += 1
            continue
        if bits.get(1) == 0:
            col[i] = _MAP_1BIT[bits.get(1)]
        else:
            col[i] = _MAP_2BIT_FAR[bits.get(2)]
        i += 1


def _f_k34(ind, bits, rows, col):
    for i in range(rows):
        if bits.get(1) == 0:
            continue
        if bits.get(1) == 0:
            col[i] = _MAP_1BIT[bits.get(1)]
        else:
            col[i] = _MAP_2BIT_FAR[bits.get(2)]


def _f_k45(ind, bits, rows, col):
    i = 0
    while i < rows:
        if bits.get(1) == 0:
            i += 2
            continue
        if bits.get(1) == 0:
            i += 1
            continue
        col[i] = _MAP_3BIT[bits.get(3)]
        i += 1


def _f_k44(ind, bits, rows, col):
    for i in range(rows):
        if bits.get(1):
            col[i] = _MAP_3BIT[bits.get(3)]


def _f_t15(ind, bits, rows, col):
    i = 0
    while i < rows:
        b = bits.get(5)
        if b >= 27:
            raise CorruptStream()
        for v in (b % 3 - 1, (b // 3) % 3 - 1, b // 9 - 1):
            col[i] = v
            i += 1
            if i >= rows:
                break


def _f_t27(ind, bits, rows, col):
    i = 0
    while i < rows:
        b = bits.get(7)
        if b >= 125:
            raise CorruptStream()
        for v in (b % 5 - 2, (b // 5) % 5 - 2, b // 25 - 2):
            col[i] = v
            i += 1
            if i >= rows:
                break


def _f_t37(ind, bits, rows, col):
    i = 0
    while i < rows:
        b = bits.get(7)
        if b >= 121:
            raise CorruptStream()
        for v in (b % 11 - 5, b // 11 - 5):
            col[i] = v
            i += 1
            if i >= rows:
                break


def _f_zero(ind, bits, rows, col):
    pass  # column already zero


def _f_bad(ind, bits, rows, col):
    raise CorruptStream()


# 32-entry dispatch table (decode.c:480-489).
FILLERS = [
    _f_zero, _f_bad, _f_bad, _f_linear,       # 0..3
    _f_linear, _f_linear, _f_linear, _f_linear,
    _f_linear, _f_linear, _f_linear, _f_linear,
    _f_linear, _f_linear, _f_linear, _f_linear,
    _f_linear, _f_k13, _f_k12, _f_t15,        # 16..19
    _f_k24, _f_k23, _f_t27, _f_k35,           # 20..23
    _f_k34, _f_bad, _f_k45, _f_k44,           # 24..27
    _f_bad, _f_t37, _f_bad, _f_bad,           # 28..31
]


@dataclasses.dataclass
class ScanResult:
    """Dense front-end output: everything the synthesis back-end needs.

    The stream is modeled as a sequence of decode *attempts* ("events"),
    exactly mirroring the reference's behavior where every `acm_read` with
    no block ready runs one `decode_block` from the current bit position —
    including after an error, when the C keeps going and re-interprets the
    following bits as a fresh block header (there is no sticky error state
    in the reference). `events[i] == 0` means attempt i produced a block;
    a negative value is the error that attempt returned. Successful
    attempts map, in order, to rows of `k`/`pwr`/`val`.
    """

    header: AcmHeader
    #: int16[n_blocks, rows, cols] coefficient indices (midbuf indices).
    k: np.ndarray
    #: uint8[n_blocks] per-block amplitude power (4-bit field).
    pwr: np.ndarray
    #: uint16[n_blocks] per-block amplitude step (16-bit field).
    val: np.ndarray
    #: number of fully decoded blocks (== count of zeros in `events`).
    n_blocks: int
    #: int16[n_events] per-attempt outcome: 0 = block, else error code.
    events: np.ndarray
    #: terminal status after the last event: ACM_EXPECTED_EOF (clean EOF at
    #: a block header / column-code boundary) or 0 (scanning stopped at the
    #: block cap — the reader never needs more).
    status: int
    #: int64[n_events] reservoir byte position after each attempt (raw_tell).
    raw_tell: np.ndarray
    #: reservoir byte position right after the header parse.
    raw_tell0: int = 0
    #: reservoir byte position after the terminal (failed) attempt.
    raw_tell_end: int = 0
    #: Stale-amp-table exceptions (see scan_blocks): coefficients whose
    #: index k lies outside the block's amplitude table. The reference
    #: then reads a stale table entry — k*val of the most recent attempt
    #: whose table covered k, or 0 if none ever did (the 256 KiB table
    #: comes from mmap'd, zeroed memory in practice). Only corrupt or
    #: hostile streams produce these. Parallel arrays:
    exc_block: np.ndarray = None  # int32 [n_exc] block index
    exc_flat: np.ndarray = None  # int32 [n_exc] flat index within block
    exc_val: np.ndarray = None  # int32 [n_exc] exact replacement value
    #: per-ATTEMPT amplitude header fields, aligned with `events` (failed
    #: attempts included — the reference regenerates its amp table from
    #: these before the attempt can fail, so seek-path table replay needs
    #: them; see table_after).
    att_pwr: np.ndarray = None  # uint8 [n_events]
    att_val: np.ndarray = None  # uint16 [n_events]

    @property
    def n_exceptions(self) -> int:
        return 0 if self.exc_block is None else len(self.exc_block)

    def table_after(self, history: "list[int] | tuple[int, ...]"):
        """Virtual amp-table state after consuming the given pass history.

        `history` lists how many attempts each decode pass consumed before
        a backward seek restarted it at attempt 0 (the reference's
        `ampbuf` persists across seeks — util.c:214-253 zeroes only
        wrapbuf). A pass that drained to EOF counts the TERMINAL attempt
        too (att may be one longer than events: an attempt that read
        pwr/val — updating the table — before clean EOF at a column
        code). Returns (last_val int64[17], covered bool[17]) suitable as
        scan_blocks(init_table=...)."""
        last_val = np.zeros(17, dtype=np.int64)
        covered = np.zeros(17, dtype=bool)
        for upto in history:
            for i in range(min(upto, len(self.att_pwr))):
                pwr = int(self.att_pwr[i])
                last_val[: pwr + 1] = int(self.att_val[i])
                covered[: pwr + 1] = True
        return last_val, covered


def scan_blocks(bits: BitReader, header: AcmHeader,
                max_blocks: int | None = None,
                init_table=None) -> ScanResult:
    """Decode the variable-length bitstream into dense coefficient tensors.

    Mirrors decode_block/fill_block (decode.c:491-502, 580-611): per attempt
    a 4-bit pwr + 16-bit val header, then per column a 5-bit filler code and
    that filler's coefficients. EOF at the pwr/val reads *or* at a column
    code is a clean end of stream (GET_BITS_EXPECT_EOF, decode.c:154-163 is
    used at both sites); EOF inside a filler is ERR_UNEXPECTED_EOF and an
    invalid filler code / packed value is ERR_CORRUPT — both recorded as
    events after which scanning continues from the current bit position,
    like the reference's next decode_block call would.
    """
    rows, cols = header.rows, header.cols
    if max_blocks is None:
        max_blocks = header.n_blocks
    k_all = []
    pwr_all = []
    val_all = []
    events = []
    tell_all = []
    exc = []  # (block, flat, value) stale-table exceptions
    status = 0
    # virtual amp table: last_val[e] = val of the most recent attempt whose
    # table covered indexes needing exponent e (the reference regenerates
    # the table at every attempt, decode.c:591-599, so even attempts that
    # later fail update it). init_table seeds a dirty table — the state a
    # backward seek inherits (ScanResult.table_after).
    if init_table is not None:
        last_val = np.array(init_table[0], dtype=np.int64)
        covered = np.array(init_table[1], dtype=bool)
    else:
        last_val = np.zeros(17, dtype=np.int64)
        covered = np.zeros(17, dtype=bool)
    att_pwr = []
    att_val = []
    while len(k_all) < max_blocks:
        try:
            pwr = bits.get(4)
            val = bits.get(16)
        except BitsExhausted:
            status = ACM_EXPECTED_EOF
            break
        last_val[: pwr + 1] = val
        covered[: pwr + 1] = True
        att_pwr.append(pwr)
        att_val.append(val)
        k = np.zeros((rows, cols), dtype=np.int16)
        outcome = 0
        try:
            for c in range(cols):
                try:
                    ind = bits.get(5)
                except BitsExhausted:
                    outcome = ACM_EXPECTED_EOF
                    raise
                FILLERS[ind](ind, bits, rows, k[:, c])
        except BitsExhausted:
            if outcome == ACM_EXPECTED_EOF:
                status = ACM_EXPECTED_EOF
                break
            outcome = int(AcmError.ERR_UNEXPECTED_EOF)
        except CorruptStream:
            outcome = int(AcmError.ERR_CORRUPT)
        events.append(outcome)
        tell_all.append(bits.loaded_bytes)
        if outcome == 0:
            count = 1 << pwr
            kf = k.reshape(-1)
            oob = np.nonzero((kf < -count) | (kf > count - 1))[0]
            for flat in oob:
                ki = int(kf[flat])
                e = int(np.ceil(np.log2(ki + 1 if ki >= 0 else -ki)))
                v = int(last_val[e]) if covered[e] else 0
                exc.append((len(k_all), int(flat), ki * v))
            k_all.append(k)
            pwr_all.append(pwr)
            val_all.append(val)
    k_arr = (
        np.stack(k_all) if k_all else np.zeros((0, rows, cols), dtype=np.int16)
    )
    e_blk, e_flat, e_val = (
        zip(*exc) if exc else ((), (), ())
    )
    return ScanResult(
        header=header,
        k=k_arr,
        pwr=np.asarray(pwr_all, dtype=np.uint8),
        val=np.asarray(val_all, dtype=np.uint16),
        n_blocks=len(k_all),
        events=np.asarray(events, dtype=np.int16),
        status=status,
        raw_tell=np.asarray(tell_all, dtype=np.int64),
        raw_tell_end=bits.loaded_bytes,
        exc_block=np.asarray(e_blk, dtype=np.int32),
        exc_flat=np.asarray(e_flat, dtype=np.int32),
        exc_val=np.asarray(e_val, dtype=np.int32),
        att_pwr=np.asarray(att_pwr, dtype=np.uint8),
        att_val=np.asarray(att_val, dtype=np.uint16),
    )


def scan_bytes(data: bytes, max_blocks: int | None = None) -> ScanResult:
    """Header parse + full scan of an in-memory ACM/WAVC stream."""
    bits = BitReader(data)
    header = parse_header(bits)
    if header is None:
        raise ValueError("not an ACM stream")
    tell0 = bits.loaded_bytes
    res = scan_blocks(bits, header, max_blocks)
    res.raw_tell0 = tell0
    return res


# ---------------------------------------------------------------------------
# Synthesis filterbank — NumPy reference (decode.c:508-577).
#
# Each pass is a pure order-2 FIR over *raw* inputs (verified in SURVEY §2.6):
#   y[n] = s[n] + 2*s[n-1] + s[n-2]   (n even)
#   y[n] = 2*s[n-1] - s[n-2] - s[n]   (n odd)
# with s[-2], s[-1] supplied by the pass's wrapbuf segment and the segment
# updated to the last two raw inputs. Pass p views the flat block as
# (rows << (p+1), cols >> (p+1)); after pass 0 only, +1 is added to element 0
# of each pass-0 row (the rounding bias, decode.c:561-565). Strip blocking in
# the reference is a cache artifact and does not affect results.
# ---------------------------------------------------------------------------


def synth_block(
    k: np.ndarray, val: int, level: int, wrap: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """One block: dequantize + filterbank. Returns (words int32[rows*cols],
    new wrap int32[2*cols-2]). All arithmetic wraps modulo 2**32."""
    rows, cols = k.shape
    x = (k.astype(np.int32) * np.int32(val)).reshape(-1)
    if level == 0:
        return x, wrap
    wrap = wrap.copy()
    off = 0
    for p in range(level):
        sub_len = cols >> (p + 1)
        sub_cnt = rows << (p + 1)
        mat = x.reshape(sub_cnt, sub_len)
        seg = wrap[off : off + 2 * sub_len].reshape(2, sub_len)
        s = np.concatenate([seg, mat], axis=0)
        a, b, c = s[2:], s[1:-1], s[:-2]
        sgn = np.where((np.arange(sub_cnt) & 1) == 0, 1, -1).astype(np.int32)[:, None]
        y = sgn * (a + c) + 2 * b
        if p == 0:
            y[:, 0] += 1
        wrap[off : off + 2 * sub_len] = mat[-2:].reshape(-1)
        x = y.reshape(-1)
        off += 2 * sub_len
    return x, wrap


def synth_all(scan: ScanResult) -> np.ndarray:
    """Synthesize every scanned block → int32 word stream (pre-shift).

    Applies stale-amp-table exceptions (out-of-range coefficient indexes;
    see ScanResult) exactly as the reference's persistent table would.
    """
    h = scan.header
    wrap = np.zeros(h.wrapbuf_len, dtype=np.int32)
    out = np.empty(scan.n_blocks * h.block_len, dtype=np.int32)
    for i in range(scan.n_blocks):
        words, wrap = _synth_block_exc(scan, i, wrap)
        out[i * h.block_len : (i + 1) * h.block_len] = words
    return out


def _synth_block_exc(scan: ScanResult, i: int, wrap: np.ndarray):
    """synth_block for scanned block i with exception overrides applied."""
    h = scan.header
    if scan.n_exceptions and np.any(scan.exc_block == i):
        x = (scan.k[i].astype(np.int32).reshape(-1) * np.int32(scan.val[i]))
        m = scan.exc_block == i
        x[scan.exc_flat[m]] = scan.exc_val[m]
        return synth_block_values(x, h.level, h.rows, wrap)
    return synth_block(scan.k[i], int(scan.val[i]), h.level, wrap)


def synth_block_values(
    x: np.ndarray, level: int, rows: int, wrap: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """synth_block starting from already-dequantized int32 values."""
    cols = 1 << level
    return synth_block(
        x.reshape(rows, cols), 1, level, wrap
    )


def words_to_pcm(words: np.ndarray, level: int) -> np.ndarray:
    """int32 words → int16 samples: arithmetic >> level, truncate to 16 bits
    (out_s16le, decode.c:617-625 — no saturation, by contract)."""
    return (words >> np.int32(level)).astype(np.int16)


def decode_bytes(data: bytes, max_blocks: int | None = None) -> tuple[AcmHeader, np.ndarray, int]:
    """Convenience: full decode of an in-memory stream.

    Returns (header, int16 PCM words clamped to total_values, status). The
    clamp mirrors acm_read's stream_pos >= total_values stop (decode.c:837,
    853-854). `status` is the first error event if any, else the scan's
    terminal status (0 / ACM_EXPECTED_EOF).
    """
    scan = scan_bytes(data, max_blocks)
    words = synth_all(scan)
    pcm = words_to_pcm(words, scan.header.level)
    if len(pcm) > scan.header.total_values:
        pcm = pcm[: scan.header.total_values]
    errs = scan.events[scan.events < 0]
    status = int(errs[0]) if len(errs) else scan.status
    return scan.header, pcm, status
