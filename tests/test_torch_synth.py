"""PyTorch synthesis (libacm_tpu_torch.ops.synth_torch) ≡ the JAX package.

Same inputs, made with numpy from a seed, go through both packages on the
CPU; results cross as numpy and must be bit-equal (an integer codec: the
tolerance is 0). Also covers a pure-torch model of the CUDA fused
kernel's tiling schedule, so its index math is held to the plain version
here, where the kernel itself cannot run.
"""

import numpy as np
import pytest
import torch

from libacm_tpu import testing
from libacm_tpu.ops import synth_jax as sj
from libacm_tpu.scan import oracle
from libacm_tpu_torch.ops import synth_cuda as sc
from libacm_tpu_torch.ops import synth_torch as st

# tests/test_synth_pallas.py's geometries, plus rows == 1 and level 15
GEOMETRIES = [
    (7, 16, 2, 3), (3, 16, 1, 4), (1, 64, 2, 2), (4, 8, 1, 3),
    (5, 36, 2, 2), (2, 32, 1, 2), (6, 6, 1, 2),
    (8, 4, 2, 3), (9, 3, 1, 2), (10, 1, 2, 2), (12, 2, 1, 2),
    (13, 2, 1, 2), (14, 1, 1, 2),
    (0, 7, 2, 2), (3, 8, 1, 4), (1, 5, 2, 2), (4, 1, 1, 3),
    (5, 33, 2, 2), (15, 16, 1, 2),
    (1, 1, 2, 5), (6, 1, 2, 4), (15, 1, 1, 3),
]


def _inputs(level, rows, B, nb, seed=None):
    rng = np.random.default_rng(level * 31 + rows if seed is None else seed)
    cols = 1 << level
    k = rng.integers(-2000, 2000, (B, nb, rows, cols)).astype(np.int16)
    v = rng.integers(0, 1 << 16, (B, nb)).astype(np.int32)
    w = rng.integers(-500, 500, (B, max(2 * cols - 2, 1))).astype(np.int32)
    return k, v, w


@pytest.mark.parametrize("level,rows,B,nb", GEOMETRIES)
def test_torch_synth_matches_jax(level, rows, B, nb):
    k, v, w = _inputs(level, rows, B, nb)
    want_pcm, want_w = sj.synth_pcm_batch(k, v, w, level=level, rows=rows)
    got_pcm, got_w = st.synth_pcm_batch(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(w),
        level=level, rows=rows)
    assert got_pcm.dtype == torch.int16
    np.testing.assert_array_equal(np.asarray(want_pcm), got_pcm.numpy())
    if level:
        np.testing.assert_array_equal(np.asarray(want_w), got_w.numpy())


@pytest.mark.parametrize("level,rows", [(7, 16), (4, 40), (10, 4), (3, 2)])
def test_torch_carry_of_block_matches_jax(level, rows):
    rng = np.random.default_rng(level + rows)
    cols = 1 << level
    k = rng.integers(-3000, 3000, (rows, cols)).astype(np.int16)
    val = np.int32(rng.integers(1, 1 << 16))
    want = sj.carry_of_block(np.asarray(k), np.asarray(val), level=level,
                             rows=rows)
    got = st.carry_of_block(torch.from_numpy(k), torch.tensor(val),
                            level=level, rows=rows)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_torch_synth_int32_wraparound():
    """Products and FIR sums wrap in int32 exactly as in the JAX package."""
    level, rows, B, nb = 5, 4, 1, 3
    cols = 1 << level
    k = np.full((B, nb, rows, cols), 32767, np.int16)
    k[..., 1::2] = -32768
    v = np.full((B, nb), 65535, np.int32)
    w = np.full((B, 2 * cols - 2), 2**31 - 1, np.int32)
    want_pcm, want_w = sj.synth_pcm_batch(k, v, w, level=level, rows=rows)
    got_pcm, got_w = st.synth_pcm_batch(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(w),
        level=level, rows=rows)
    np.testing.assert_array_equal(np.asarray(want_pcm), got_pcm.numpy())
    np.testing.assert_array_equal(np.asarray(want_w), got_w.numpy())


def test_torch_synth_empty_stream():
    pcm, wrap = st.synth_pcm_batch(
        torch.zeros((2, 0, 4, 8), dtype=torch.int16),
        torch.zeros((2, 0), dtype=torch.int32),
        torch.ones((2, 14), dtype=torch.int32), level=3, rows=4)
    assert pcm.shape == (2, 0, 32)
    assert torch.equal(wrap, torch.ones((2, 14), dtype=torch.int32))


def test_torch_full_decode_matches_oracle():
    """End-to-end: oracle scan + torch synth == oracle decode."""
    rng = np.random.default_rng(77)
    data = testing.random_acm_bytes(rng, level=4, rows=20, n_blocks=5,
                                    max_pwr=15)
    scan = oracle.scan_bytes(data)
    want = oracle.words_to_pcm(oracle.synth_all(scan), 4)
    pcm, _ = st.synth_pcm_batch(
        torch.from_numpy(scan.k[None]),
        torch.from_numpy(scan.val.astype(np.int32)[None]),
        torch.zeros((1, scan.header.wrapbuf_len), dtype=torch.int32),
        level=4, rows=20)
    np.testing.assert_array_equal(pcm.numpy().reshape(-1), want)


# --- model of the fused kernel's tiling schedule (csrc/synth.cu) ----------

_M32 = 0xFFFFFFFF


def _to_pcm(u: torch.Tensor, level: int) -> torch.Tensor:
    signed = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return ((signed >> level) & 0xFFFF).to(torch.int32).to(torch.int16)


def _strips(sh, N, nt):
    """(s, Qtot, Q, C) of a pass of stride s = 1 << sh over N elements cut
    into strips for nt threads: C runs of Q steps per residue, Q odd and
    at least 3 (so a run past q = 0 finds its halo in the input)."""
    s = 1 << sh
    Qtot = N >> sh
    C = nt >> sh if s < nt else 1
    return s, Qtot, max(((Qtot + C - 1) // C) | 1, 3), C


def _strip_pass(src, dst, carry, off, *, sh, N, nt, bias):
    """One strip-walked pass: items (r, c) step through q in lockstep.

    src(q, r) is the pass's input at element q*s + r, dst the buffer the
    output goes to (the pass-0 input is staging, later passes work in
    place). An item at q0 == 0 takes its halo from the carry, any other
    from the input; the item whose run ends at N/s writes the new carry.
    """
    s, Qtot, Q, C = _strips(sh, N, nt)
    if C > 1:  # one item per thread: r = tid % s, c = tid / s
        tid = torch.arange(nt)
        r, q0 = tid % s, (tid // s) * Q
        q1 = torch.clamp(q0 + Q, max=Qtot)
    else:  # each thread walks whole residues
        r = torch.arange(s)
        q0, q1 = torch.zeros(s, dtype=torch.int64), torch.full((s,), Qtot)
    live = q0 < q1
    r, q0, q1 = r[live], q0[live], q1[live]
    head = q0 == 0
    x2 = torch.where(head, carry[off + r],
                     src(torch.clamp(q0 - 2, min=0), r))
    x1 = torch.where(head, carry[off + s + r],
                     src(torch.clamp(q0 - 1, min=0), r))
    b = (r == 0).to(torch.int64) if bias else torch.zeros_like(r)
    for i in range(int((q1 - q0).max())):
        q = q0 + i
        on = q < q1
        a = src(torch.where(on, q, 0), r)
        even = (q & 1) == 0
        t = (a + x2) & _M32
        y = (torch.where(even, t, (-t) & _M32) + 2 * x1 + b) & _M32
        dst[(q[on] << sh) + r[on]] = y[on]
        x2, x1 = torch.where(on, x1, x2), torch.where(on, a, x1)
    tail = q1 == Qtot
    carry[off + r[tail]] = x2[tail]
    carry[off + s + r[tail]] = x1[tail]


def _fir_at(a, m, c, f, sh):
    """One FIR step on uint32 words (ints) at position f of stride 1 << sh."""
    t = (a + c) & _M32
    return ((2 * m - t) if (f >> sh) & 1 else (t + 2 * m)) & _M32


def _halos_at(X, P, K):
    """halos_at: {s: the inputs of the pass of stride s on [P-2s, P)} for
    the last K passes, from the first one's inputs X[P-W, P)."""
    W = 2 * ((1 << K) - 1)
    u = [0] * 16
    for i in range(16 - W, 16):
        u[i] = int(X[P - 16 + i])
    h = {}
    if K >= 3:
        h[4] = u[8:16]
        for i in range(15, 9, -1):
            u[i] = _fir_at(u[i], u[i - 4], u[i - 8], P - 16 + i, 2)
    if K >= 2:
        h[2] = u[12:16]
        for i in range(15, 13, -1):
            u[i] = _fir_at(u[i], u[i - 2], u[i - 4], P - 16 + i, 1)
    h[1] = u[14:16]
    return h


def _last_passes(X, carry, *, N, wlen, K):
    """The last K passes (strides 4, 2, 1) in groups of 8 elements. A
    group's halo of each pass is the group before's values there (a
    shuffle from the lane before); a warp's lane 0 (g % 32 == 0) takes
    the carry at g = 0 and _halos_at(X, 8g) elsewhere. Thread 0 then
    writes the new carries from _halos_at(X, N). Returns the N outputs."""
    NG = -(-N // 8)
    v = torch.zeros(8 * NG, dtype=torch.int64)
    v[:N] = X[:N]
    v = v.reshape(NG, 8)
    if K == 0:
        return v.reshape(-1)[:N]
    lane0 = {0: {4: carry[wlen - 14 : wlen - 6].tolist(),
                 2: carry[wlen - 6 : wlen - 2].tolist(),
                 1: carry[wlen - 2 : wlen].tolist()}}
    for g in range(32, NG, 32):
        lane0[g] = _halos_at(X, 8 * g, K)
    for S in (4, 2, 1)[3 - K :]:
        h = torch.zeros((NG, 2 * S), dtype=torch.int64)
        h[1:] = v[:-1, 8 - 2 * S :]
        for g, halos in lane0.items():
            h[g] = torch.tensor(halos[S], dtype=torch.int64)
        y = torch.empty_like(v)
        for i in range(8):
            m = v[:, i - S] if i >= S else h[:, i + S]
            c = v[:, i - 2 * S] if i >= 2 * S else h[:, i]
            t = (v[:, i] + c) & _M32
            y[:, i] = ((2 * m - t) if (i // S) & 1 else (t + 2 * m)) & _M32
        v = y
    for S, new in _halos_at(X, N, K).items():
        off = wlen - 4 * S + 2
        carry[off : off + 2 * S] = torch.tensor(new, dtype=torch.int64)
    return v.reshape(-1)[:N]


def _fused_model(k, vals, wrap0, *, level, rows, T, span,
                 nt=sc._FUSED_THREADS):
    """synth_fused_kernel's schedule in torch, uint32 math as int64 & M32.

    One "CTA" of nt threads per (file, span of `span` blocks). The span
    at block 0 starts from wrap0; any other span first synthesizes block
    blk0-1 from a zero carry and discards its PCM. The CTA walks its
    blocks in tiles of T, in order, carrying each pass's last 2s inputs
    in an array of 2*cols-2 words in wrap layout (pass p at offset sum of
    2*s_q, q < p). Pass 0 dequantizes the tile's staged k with the vals of
    its block (one run of steps per block); passes 1..level-1-K walk
    strips in place; the last K = min(3, level - 1) passes run in groups
    of 8 (_last_passes). The CTA whose span ends at block nb writes
    wrap_f.
    """
    B, nb = k.shape[:2]
    cols = 1 << level
    n = rows * cols
    wlen = 2 * cols - 2
    R2 = 2 * rows  # pass-0 steps per block
    kk = k.to(torch.int64).reshape(B, nb * n)
    vv = vals.to(torch.int64)
    w0 = wrap0.to(torch.int64) & _M32
    pcm = torch.empty((B, nb * n), dtype=torch.int16)
    wrapf = torch.empty((B, wlen), dtype=torch.int64)
    for b in range(B):
        for blk0 in range(0, nb, span):
            blk_end = min(nb, blk0 + span)
            first = blk0 - 1 if blk0 else 0
            carry = w0[b].clone() if blk0 == 0 else torch.zeros(
                wlen, dtype=torch.int64)
            for tblk in range(first, blk_end, T):
                Tt = min(T, blk_end - tblk)
                N = Tt * n
                stage = kk[b, tblk * n : tblk * n + N]  # the prefetched k
                tv = vv[b, tblk : tblk + Tt]  # the tile's vals
                X = torch.zeros(N, dtype=torch.int64)
                sh0 = level - 1

                def deq(q, r):
                    return (stage[(q << sh0) + r] * tv[q // R2]) & _M32

                _strip_pass(deq, X, carry, 0, sh=sh0, N=N, nt=nt, bias=True)
                K = min(3, level - 1)
                off = cols
                for p in range(1, level - K):
                    sh = level - 1 - p
                    _strip_pass(lambda q, r: X[(q << sh) + r], X, carry, off,
                                sh=sh, N=N, nt=nt, bias=False)
                    off += 2 << sh
                y = _last_passes(X, carry, N=N, wlen=wlen, K=K)
                skip = max(blk0 - tblk, 0) * n  # the re-synthesized block
                pcm[b, tblk * n + skip : tblk * n + N] = _to_pcm(y, level)[
                    skip:]
            if blk_end == nb:
                wrapf[b] = carry
    wrapf = torch.where(wrapf >= 1 << 31, wrapf - (1 << 32), wrapf)
    return pcm.reshape(B, nb, n), wrapf.to(torch.int32)


def _check_model(level, rows, B, nb, T, span, nt=sc._FUSED_THREADS):
    k, v, w = _inputs(level, rows, B, nb, seed=level * 7 + nb)
    k, v, w = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(w)
    want_pcm, want_w = st.synth_pcm_batch(k, v, w, level=level, rows=rows)
    got_pcm, got_w = _fused_model(k, v, w, level=level, rows=rows, T=T,
                                  span=span, nt=nt)
    assert torch.equal(want_pcm, got_pcm)
    assert torch.equal(want_w, got_w)


@pytest.mark.parametrize("level,rows,B,nb,T", [
    (7, 16, 2, 7, 3),  # ragged last tile
    (7, 16, 1, 9, None),  # the plan's own tile
    (4, 40, 2, 5, 2), (10, 4, 1, 4, 1), (5, 33, 2, 3, 2), (9, 3, 1, 5, 4),
    (1, 2, 2, 6, 4), (3, 2, 1, 8, 8), (12, 2, 1, 3, None),
])
def test_fused_schedule_model_matches_plain(level, rows, B, nb, T):
    """The plan for a card with two slots per file: two spans per file,
    the second cut mid-file."""
    T0, span = sc.fused_plan(level, rows, B, nb, slots=2 * B)
    assert T0 >= 1
    _check_model(level, rows, B, nb, T or T0, span)


#: (level, rows, B, nb, T, span, threads); None takes fused_plan's choice
#: for a card with 264 resident CTAs (132 SMs x 2)
@pytest.mark.parametrize("level,rows,B,nb,T,span,nt", [
    (7, 16, 2, 7, 3, 5, 256),  # span ends mid-file, ragged last tile
    (7, 16, 3, 5, 2, 1, 256),  # every span one block
    (7, 16, 1, 3, 7, 3, 256),  # nb < T
    (7, 16, 25, 32, None, None, 256),  # the plan at the main path's B
    (4, 40, 3, 11, 4, 4, 256),  # spans do not divide nb
    (4, 40, 2, 9, 3, 4, 8),  # pass 0: one run per residue (s == nt)
    (10, 4, 2, 5, 2, 3, 256),  # pass 0: s > nt
    (9, 3, 2, 4, 2, 3, 256),  # pass 0: s == nt
    (10, 4, 1, 4, 1, 4, 128),  # s > nt: threads walk several residues
    (10, 4, 3, 10, None, None, 256),
    (1, 2, 2, 6, 4, 6, 256), (1, 3, 2, 9, 3, 4, 32),  # level 1
    (2, 3, 2, 7, 2, 3, 16),  # n % 8 != 0
    (2, 40, 1, 4, 3, 4, 256), (3, 40, 1, 3, 2, 3, 256),  # K = 1, 2
    (5, 33, 2, 3, 2, 2, 64), (12, 2, 1, 3, None, None, 256),
])
def test_fused_schedule_model_edges(level, rows, B, nb, T, span, nt):
    if T is None:
        T, span = sc.fused_plan(level, rows, B, nb, slots=264)
    assert T >= 1 and span >= 1
    _check_model(level, rows, B, nb, T, span, nt)


@pytest.mark.parametrize("level,rows,nb,route", [
    (7, 16, 320, "fused"), (4, 40, 1216, "fused"), (10, 4, 160, "fused"),
    (5, 33, 64, "fused"), (9, 3, 8, "fused"), (12, 2, 4, "fused"),
    (11, 3, 4, "fused"), (1, 3, 5, "fused"), (12, 3, 2, "pass"),
    (0, 2048, 416, "pass"), (10, 1, 8, "pass"), (14, 1, 4, "pass"),
    (15, 16, 2, "pass"), (13, 2, 4, "pass"),
])
def test_fused_tile_predicate(level, rows, nb, route):
    """Fused route iff level >= 1, rows >= 2 and a tile of one block
    leaves room for two CTAs per SM; the tile is the largest for which two
    CTAs fit."""
    T = sc.fused_tile(level, rows, nb)
    assert (T >= 1) == (route == "fused")
    if T:
        assert 2 * (sc.fused_smem_bytes(level, rows, T)
                    + sc.CTA_RESERVED) <= sc.SM_SMEM
        assert T == nb or sc.fused_smem_bytes(level, rows,
                                              T + 1) > sc.TILE_SMEM


@pytest.mark.parametrize("level,rows,B,nb,slots", [
    (7, 16, 25, 320, 264), (4, 40, 15, 1216, 264), (10, 4, 10, 160, 264),
    (7, 16, 400, 13, 264), (7, 16, 1, 3, 264), (4, 40, 7, 100, 30),
])
def test_fused_plan_fills_one_wave(level, rows, B, nb, slots):
    """Spans cut each file evenly; the grid is at most one wave of
    resident CTAs where there are no more files than slots, and one CTA
    per file otherwise; the tile is no longer than a span plus the block
    re-synthesized before it."""
    T, span = sc.fused_plan(level, rows, B, nb, slots)
    grid = B * -(-nb // span)
    assert 1 <= T <= min(sc.fused_tile(level, rows, nb), span + 1)
    if B <= slots:
        assert grid <= slots
        assert span == 1 or B * -(-nb // (span - 1)) > slots
    else:
        assert span == nb


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the kernel wrapper is the plain version and launches
    nothing."""
    k, v, w = _inputs(7, 16, 2, 3)
    sc.reset_launches()
    got = sc.synth_pcm_batch(torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(w), level=7, rows=16)
    want = st.synth_pcm_batch(torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(w), level=7, rows=16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sc.launches == {"synth_fused": 0, "synth_pass": 0}
