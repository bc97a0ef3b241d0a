"""ACM encoder — capability beyond the reference (which is decode-only).

Two analysis tools:

**Exact inverse** (`analyze_block`): the filterbank is bijective on ℤⁿ in
wrapping int32 arithmetic (every pass is unimodular), so each pass inverts
sequentially:  s[n] = ±(y[n] - 2·s[n-1]) - s[n-2].  This is exact but the
inverse operator is *unbounded* — only signals already in the image of
small coefficients have small preimages (useful for remux/verification,
not for encoding arbitrary audio).

**Production analysis** (`encode_pcm`): like any transform codec, encoding
generic PCM means finding *small* coefficients whose synthesis is *close*
to the target — a ridge-regularized least-squares problem

    min ||A x - t||² + λ||x||²

solved with conjugate gradient on the normal equations. The forward
operator A is the cascade of FIR passes; its adjoint is the mirrored
stencil (Aᵀy)[m] = ±(y[m] + y[m+2]) + 2·y[m+1] in reverse cascade order —
both pure shifted adds, fully vectorized (backend="torch" runs them as
float32 tensor ops on the card). The inter-block carry and the +1 rounding bias enter as a
fixed offset (y = A·x + offset), keeping the system linear. Coefficients
are then quantized to the per-block (pwr, val) grid and written with the
cheapest covering filler; the reported `max_error` is measured by running
the real integer synthesis on the quantized stream.

The port of libacm_tpu/encode.py: a copy but for `_analyze_ridge_torch`,
which takes the place of the JAX package's jitted `_analyze_ridge_jax`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .format import AcmHeader
from .testing import BitWriter, choose_filler_best, encode_column, write_header

_U32 = np.uint32
_I32 = np.int32


def inverse_pass(y: np.ndarray, carry: np.ndarray) -> np.ndarray:
    """Invert one FIR pass: y [cnt, sub_len] + carry [2, sub_len] → s.

    Exact inverse of the forward pass in wrapping 32-bit arithmetic.
    """
    cnt, sub_len = y.shape
    s = np.empty((cnt + 2, sub_len), dtype=_U32)
    s[0] = carry[0]
    s[1] = carry[1]
    yu = y.astype(_U32)
    for n in range(cnt):
        prev1 = s[n + 1]
        prev2 = s[n]
        if n % 2 == 0:  # y = s + 2*s1 + s2  ->  s = y - 2*s1 - s2
            s[n + 2] = yu[n] - 2 * prev1 - prev2
        else:  # y = -s + 2*s1 - s2  ->  s = 2*s1 - s2 - y
            s[n + 2] = 2 * prev1 - prev2 - yu[n]
    return s[2:].astype(_I32)


def analyze_block(
    words: np.ndarray, level: int, rows: int, wrap: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Exact analysis: int32 words [rows*cols] → coefficients x0 + new wrap.

    `wrap` is the running carry in the decoder's wrapbuf layout
    ([2*cols-2]); it is updated to what the decoder will have after
    synthesizing this block (the recovered raw-input tails).
    """
    cols = 1 << level
    x = words.astype(_I32)
    wrap = wrap.copy()
    # invert passes in reverse order; subtract the pass-0 rounding bias
    # from pass 0's output before inverting it (decode.c:561-565)
    offs = []
    off = 0
    for p in range(level):
        sub_len = cols >> (p + 1)
        offs.append((p, off, sub_len))
        off += 2 * sub_len
    for p, off_p, sub_len in reversed(offs):
        cnt = rows << (p + 1)
        y = x.reshape(cnt, sub_len)
        if p == 0:
            y = y.copy()
            y[:, 0] = (y[:, 0].astype(_U32) - 1).astype(_I32)
        carry = wrap[off_p : off_p + 2 * sub_len].reshape(2, sub_len)
        s = inverse_pass(y, carry.astype(_U32))
        wrap[off_p : off_p + 2 * sub_len] = s[-2:].reshape(-1)
        x = s.reshape(-1)
    return x, wrap


def quantize_block(x0: np.ndarray, pwr: int) -> tuple[int, np.ndarray]:
    """Pick (val, k) for coefficients x0 under a 4-bit pwr budget.

    val = ceil(max|x0| / 2^pwr) (minimum step that covers the range);
    k = round(x0 / val) clamped to [-2^pwr, 2^pwr - 1].
    """
    count = 1 << pwr
    amax = float(np.max(np.abs(x0))) if x0.size else 0.0
    val = max(1, int(np.ceil(amax / count)))
    if val >= 1 << 16:
        val = (1 << 16) - 1  # extreme content: saturate the step field
    k = np.round(np.asarray(x0, dtype=np.float64) / val)
    k = np.clip(k, -count, count - 1).astype(np.int32)
    return val, k


def _forward(x: np.ndarray, level: int, rows: int) -> np.ndarray:
    """Float synthesis A·x (zero carry, no bias): cascade of FIR passes."""
    cols = 1 << level
    for p in range(level):
        sub_len = cols >> (p + 1)
        cnt = rows << (p + 1)
        m = x.reshape(cnt, sub_len)
        s1 = np.vstack([np.zeros((1, sub_len)), m[:-1]])
        s2 = np.vstack([np.zeros((2, sub_len)), m[:-2]])
        sgn = np.where((np.arange(cnt) & 1) == 0, 1.0, -1.0)[:, None]
        x = (sgn * (m + s2) + 2 * s1).reshape(-1)
    return x


def _adjoint(y: np.ndarray, level: int, rows: int) -> np.ndarray:
    """Aᵀ·y — mirrored stencil, passes in reverse order."""
    cols = 1 << level
    for p in reversed(range(level)):
        sub_len = cols >> (p + 1)
        cnt = rows << (p + 1)
        m = y.reshape(cnt, sub_len)
        d1 = np.vstack([m[1:], np.zeros((1, sub_len))])
        d2 = np.vstack([m[2:], np.zeros((2, sub_len))])
        sgn = np.where((np.arange(cnt) & 1) == 0, 1.0, -1.0)[:, None]
        y = (sgn * (m + d2) + 2 * d1).reshape(-1)
    return y


def _offset(level: int, rows: int, wrap: np.ndarray) -> np.ndarray:
    """Synthesis of x = 0 under the current carry + rounding bias (the
    affine part of the block's synthesis map)."""
    cols = 1 << level
    n = rows * cols
    x = np.zeros(n)
    off = 0
    for p in range(level):
        sub_len = cols >> (p + 1)
        cnt = rows << (p + 1)
        m = x.reshape(cnt, sub_len)
        seg = wrap[off : off + 2 * sub_len].astype(np.float64).reshape(2, sub_len)
        full = np.vstack([seg, m])
        sgn = np.where((np.arange(cnt) & 1) == 0, 1.0, -1.0)[:, None]
        y = sgn * (full[2:] + full[:-2]) + 2 * full[1:-1]
        if p == 0:
            y[:, 0] += 1.0
        x = y.reshape(-1)
        off += 2 * sub_len
    return x


def _cg_fit(t: np.ndarray, level: int, rows: int, lam: float, iters: int,
            x0: np.ndarray | None = None) -> np.ndarray:
    """argmin ||A x - t||² + λ||x||² via CG on the normal equations."""
    x = np.zeros_like(t) if x0 is None else x0.copy()
    r = _adjoint(t - _forward(x, level, rows), level, rows) - lam * x
    p = r.copy()
    rs = float(r @ r)
    for _ in range(iters):
        if rs == 0.0:
            break
        ap = _adjoint(_forward(p, level, rows), level, rows) + lam * p
        alpha = rs / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = float(r @ r)
        if rs_new < 1e-14 * max(rs, 1.0):
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def _analyze_ridge_torch(t_lo: np.ndarray, level: int, rows: int,
                         lam: float, iters: int, outer: int,
                         device=None) -> np.ndarray:
    """Device path of analyze_ridge's box-projected CG, in torch.

    The forward/adjoint cascades are pure shifted adds, so long-stream
    encodes run on `device` (None: the card, see device.resolve_device)
    as tensor ops, with a fixed iteration count and no host round trip
    inside the solve. float32 is sufficient: the fit residual target is
    the 2^level low-bit box, far above float32 noise for in-range audio.
    """
    import torch

    from .device import resolve_device

    dev = resolve_device(device)
    cols = 1 << level
    passes = []  # (cnt, sub_len, sign column) per pass
    for p in range(level):
        sub_len = cols >> (p + 1)
        cnt = rows << (p + 1)
        sgn = torch.ones((cnt, 1), dtype=torch.float32, device=dev)
        sgn[1::2] = -1.0
        passes.append((cnt, sub_len, sgn))

    def fwd(x):
        for cnt, sub_len, sgn in passes:
            m = x.reshape(cnt, sub_len)
            z = m.new_zeros((2, sub_len))
            s1 = torch.cat([z[:1], m[:-1]])
            s2 = torch.cat([z, m[:-2]])
            x = (sgn * (m + s2) + 2 * s1).reshape(-1)
        return x

    def adj(y):
        for cnt, sub_len, sgn in reversed(passes):
            m = y.reshape(cnt, sub_len)
            z = m.new_zeros((2, sub_len))
            d1 = torch.cat([m[1:], z[:1]])
            d2 = torch.cat([m[2:], z])
            y = (sgn * (m + d2) + 2 * d1).reshape(-1)
        return y

    t_lo = torch.from_numpy(t_lo.astype(np.float32)).to(dev)
    t_hi = t_lo + (2.0**level - 1.0)
    t = t_lo + 2.0**level / 2.0
    x = torch.zeros_like(t_lo)
    for _ in range(max(1, outer)):
        r = adj(t - fwd(x)) - lam * x
        p = r
        rs = r @ r
        for _ in range(iters):
            ap = adj(fwd(p)) + lam * p
            alpha = rs / (p @ ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = r @ r
            p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
            rs = rs_new
        t = torch.minimum(torch.maximum(fwd(x), t_lo), t_hi)
    return x.cpu().numpy().astype(np.float64)


def analyze_ridge(
    target_words: np.ndarray,
    level: int,
    rows: int,
    wrap: np.ndarray,
    lam: float = 1e-6,
    iters: int = 96,
    outer: int = 4,
    backend: str = "numpy",
    device=None,
) -> np.ndarray:
    """Free-low-bit ridge analysis of one block.

    The decoder emits `words >> level`, so any words in
    [pcm<<level, pcm<<level + 2^level - 1] are equally correct — treating
    the low bits as free absorbs truncation noise that would otherwise
    excite near-null modes (whose carry tails poison the next block).
    Alternates projection onto that box with a warm-started CG ridge fit.
    backend="numpy" (float64 on the host) or "torch" (float32 on `device`,
    None: the card).
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown analysis backend {backend!r} "
                         "('numpy' or 'torch')")
    t_lo = target_words.astype(np.float64) - _offset(level, rows, wrap)
    if level == 0:
        return t_lo
    if backend == "torch":
        return _analyze_ridge_torch(t_lo, level, rows, lam, iters, outer,
                                    device)
    t_hi = t_lo + ((1 << level) - 1)
    t = t_lo + (1 << level) / 2.0
    x = None
    for _ in range(max(1, outer)):
        x = _cg_fit(t, level, rows, lam, iters, x0=x)
        y = _forward(x, level, rows)
        t = np.clip(y, t_lo, t_hi)
    return x


def encode_stream(
    blocks: list[tuple[int, int, np.ndarray]],  # (pwr, val, k[rows, cols])
    total_values: int,
    *,
    channels: int = 1,
    rate: int = 22050,
    level: int | None = None,
    rows: int | None = None,
    wavc: bool = False,
) -> bytes:
    """Serialize coefficient blocks into a valid ACM/WAVC stream.

    Columns are written with the cheapest covering filler. This is the
    coefficient-domain encoder: anything a decoder can read round-trips
    through it losslessly (see optimize_acm)."""
    from .testing import wavc_wrap

    if level is None:
        level = int(np.log2(blocks[0][2].shape[1]))
    if rows is None:
        rows = blocks[0][2].shape[0]
    w = BitWriter()
    write_header(w, total_values, channels, rate, level, rows)
    for pwr, val, k in blocks:
        w.put(int(pwr), 4)
        w.put(int(val), 16)
        for c in range(k.shape[1]):
            ks = k[:, c]
            encode_column(w, ks, choose_filler_best(ks))
    data = w.getvalue()
    return wavc_wrap(data, raw_size=2 * total_values) if wavc else data


def optimize_acm(data: bytes) -> bytes:
    """Losslessly re-encode an ACM/WAVC stream with optimal filler choices.

    The InterPlay grammar usually gives an encoder several fillers that can
    represent a column; historical encoders did not always pick the
    cheapest. The output decodes to bit-identical PCM (same k/pwr/val
    sequence, same geometry) and is never chosen unless it parses back to
    the identical coefficient stream (verified here).
    """
    from .scan import scan_bytes

    scan = scan_bytes(data)
    h = scan.header
    if np.any(scan.events != 0) or scan.n_blocks < h.n_blocks:
        raise ValueError("refusing to optimize a truncated/corrupt stream")
    blocks = [(int(scan.pwr[i]), int(scan.val[i]), scan.k[i])
              for i in range(scan.n_blocks)]
    out = encode_stream(blocks, h.total_values, channels=h.channels,
                        rate=h.rate, level=h.level, rows=h.rows,
                        wavc=h.wavc_file)
    check = scan_bytes(out)
    if (check.n_blocks != scan.n_blocks
            or not np.array_equal(check.k, scan.k)
            or not np.array_equal(check.val, scan.val)
            or not np.array_equal(check.pwr, scan.pwr)):
        raise AssertionError("optimize round-trip mismatch (bug)")
    return out if len(out) < len(data) else data


@dataclasses.dataclass
class EncodeResult:
    data: bytes
    header: AcmHeader
    #: max |decoded - requested| PCM error introduced by quantization
    max_error: int


def encode_pcm(
    pcm: np.ndarray,
    *,
    level: int = 7,
    rows: int = 16,
    channels: int = 1,
    rate: int = 22050,
    pwr: int = 10,
    wavc: bool = False,
    backend: str = "numpy",
    device=None,
) -> EncodeResult:
    """Encode int16 interleaved PCM into an ACM/WAVC stream.

    Produces valid streams (this framework, the C reference, and FFmpeg
    all decode them) and reports the true max output error. Analysis is a
    single global ridge fit over the whole stream (the carry chain makes
    the stream one tall block — per-block fitting cannot keep carries
    consistent), so content in or near the codec's image round-trips at
    very high SNR; content exciting the synthesis operator's spectral
    nulls (e.g. full-scale pure tones) is bounded by the codec itself
    (~16 dB — it is a ~13 kbps-class game codec). `pwr` trades bitrate
    vs quantization noise. Lossless re-encode of existing streams is
    `optimize_acm`; coefficient-domain authoring is `encode_stream`.
    `backend`/`device` select the analysis solve (see analyze_ridge).
    """
    from .testing import wavc_wrap

    pcm = np.asarray(pcm, dtype=np.int16).reshape(-1)
    total = len(pcm)
    if total == 0:
        raise ValueError("empty pcm")
    cols = 1 << level
    block_len = rows * cols
    nb = -(-total // block_len)
    padded = np.zeros(nb * block_len, dtype=np.int16)
    padded[:total] = pcm

    w = BitWriter()
    write_header(w, total, channels, rate, level, rows)
    header = AcmHeader(total_values=total, channels=channels, rate=rate,
                       level=level, rows=rows, wavc_file=wavc)

    # Global analysis: by the re-blocking invariance (SURVEY §2.6, the
    # carry chain IS block concatenation), the whole stream is one tall
    # block of rows_total = nb*rows — fitting it globally keeps the
    # inter-block carries consistent by construction (a per-block fit
    # cannot pin its carry tails to anything the next block can use).
    rows_total = nb * rows
    words_all = padded.astype(np.int64) << level
    zero_wrap = np.zeros(max(2 * cols - 2, 1), dtype=_I32)
    x_glob = analyze_ridge(words_all, level, rows_total, zero_wrap,
                           backend=backend, device=device)

    # quantize and serialize per block; re-synthesize the quantized stream
    # with the real integer decoder to report the true output error
    from .scan.oracle import synth_block

    dec_wrap = np.zeros_like(zero_wrap)
    max_err = 0
    for i in range(nb):
        x0 = x_glob[i * block_len : (i + 1) * block_len]
        val, k = quantize_block(x0, pwr)
        k2 = k.reshape(block_len)
        # a block's column c holds flat indices c, c+cols, ... (row-major)
        w.put(pwr, 4)
        w.put(val, 16)
        for c in range(cols):
            ks = k2[c::cols]
            encode_column(w, ks, choose_filler_best(ks))
        dwords, dec_wrap = synth_block(k2.reshape(rows, cols), val, level,
                                       dec_wrap)
        dpcm = (dwords >> level).astype(np.int16)
        err = np.abs(dpcm.astype(np.int32)
                     - padded[i * block_len : (i + 1) * block_len].astype(np.int32))
        if i == nb - 1 and nb * block_len != total:
            err[total - i * block_len :] = 0  # padding region
        max_err = max(max_err, int(err.max()))
    data = w.getvalue()
    if wavc:
        data = wavc_wrap(data, raw_size=2 * total)
    return EncodeResult(data=data, header=header, max_error=max_err)
