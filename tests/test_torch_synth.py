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

    One "CTA" of nt threads per (file, span of `span` blocks). A span at
    blk0 starts at block first = max(blk0 - W, 0), W =
    st.warmup_blocks(level, rows), from wrap0 where first == 0 and from a
    zero carry elsewhere, and discards the PCM of blocks before blk0 (a
    whole tile of it where a tile is shorter than W). The CTA walks its
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
    W = st.warmup_blocks(level, rows)
    kk = k.to(torch.int64).reshape(B, nb * n)
    vv = vals.to(torch.int64)
    w0 = wrap0.to(torch.int64) & _M32
    pcm = torch.empty((B, nb * n), dtype=torch.int16)
    wrapf = torch.empty((B, wlen), dtype=torch.int64)
    for b in range(B):
        for blk0 in range(0, nb, span):
            blk_end = min(nb, blk0 + span)
            first = max(blk0 - W, 0)
            carry = w0[b].clone() if first == 0 else torch.zeros(
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
                skip = min(max(blk0 - tblk, 0) * n, N)  # warm-up blocks
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
    (7, 1, 2, 5, None), (3, 1, 1, 8, 2), (1, 1, 2, 5, None),  # rows == 1
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
    # rows == 1 (W = 2 from level 2): spans that start at block 1 (their
    # warm-up reaches block 0 and takes wrap0), tiles shorter than W
    # (whole tiles of warm-up PCM dropped), spans of several tiles
    (7, 1, 2, 6, 1, 1, 256), (7, 1, 1, 9, 2, 3, 256),
    (7, 1, 2, 7, 4, 2, 256), (2, 1, 2, 9, 1, 2, 16), (2, 1, 1, 6, 3, 1, 8),
    (1, 1, 2, 7, 2, 2, 32),  # level 1: W = 1
    (12, 1, 1, 4, 1, 1, 256), (7, 1, 3, 40, None, None, 256),
    # one CTA per SM: the plan's tile for a card with 132 slots
    (12, 3, 1, 3, None, None, 256), (13, 1, 1, 3, 2, 1, 256),
])
def test_fused_schedule_model_edges(level, rows, B, nb, T, span, nt):
    if T is None:
        slots = 264 if sc.fused_budget(level, rows) == sc.TILE_SMEM else 132
        T, span = sc.fused_plan(level, rows, B, nb, slots=slots)
    assert T >= 1 and span >= 1
    _check_model(level, rows, B, nb, T, span, nt)


@pytest.mark.parametrize("level,rows,nb,route", [
    (7, 16, 320, "fused"), (4, 40, 1216, "fused"), (10, 4, 160, "fused"),
    (5, 33, 64, "fused"), (9, 3, 8, "fused"), (12, 2, 4, "fused"),
    (11, 3, 4, "fused"), (1, 3, 5, "fused"), (12, 3, 2, "fused, one CTA"),
    (0, 2048, 416, "pass"), (10, 1, 8, "fused"), (14, 1, 4, "pass"),
    (15, 16, 2, "pass"), (13, 2, 4, "fused, one CTA"),
    (10, 16, 3, "fused, one CTA"), (11, 8, 2, "fused, one CTA"),
    (12, 4, 5, "fused, one CTA"), (13, 1, 4, "fused, one CTA"),
    (7, 1, 4800, "fused"), (11, 16, 2, "pass"), (12, 8, 2, "pass"),
    (13, 3, 2, "pass"),
])
def test_fused_tile_predicate(level, rows, nb, route):
    """Fused route iff level >= 1 and a tile of one block fits one CTA
    (rows == 1 included); the tile is the largest for which two CTAs fit
    an SM where one block leaves room for two, else for which one does."""
    T = sc.fused_tile(level, rows, nb)
    assert (T >= 1) == route.startswith("fused")
    if T:
        ctas = 1 if route.endswith("one CTA") else 2
        budget = sc.fused_budget(level, rows)
        assert budget == (sc.TILE_SMEM if ctas == 2 else sc.ONE_CTA_SMEM)
        assert ctas * (sc.fused_smem_bytes(level, rows, T)
                       + sc.CTA_RESERVED) <= sc.SM_SMEM
        assert (sc.fused_smem_bytes(level, rows, 1) > sc.TILE_SMEM) == (
            ctas == 1)
        assert T == nb or sc.fused_smem_bytes(level, rows, T + 1) > budget


@pytest.mark.parametrize("level,rows,B,nb,slots", [
    (7, 16, 25, 320, 264), (4, 40, 15, 1216, 264), (10, 4, 10, 160, 264),
    (7, 16, 400, 13, 264), (7, 16, 1, 3, 264), (4, 40, 7, 100, 30),
    (7, 1, 1, 512, 264), (7, 1, 1, 4800, 264),
])
def test_fused_plan_fills_one_wave(level, rows, B, nb, slots):
    """Spans cut each file evenly; the grid is at most one wave of
    resident CTAs where there are no more files than slots, and one CTA
    per file otherwise; the tile is no longer than a span plus the block
    re-synthesized before it."""
    T, span = sc.fused_plan(level, rows, B, nb, slots)
    grid = B * -(-nb // span)
    assert 1 <= T <= min(sc.fused_tile(level, rows, nb),
                         span + st.warmup_blocks(level, rows))
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
    assert not any(sc.launches.values())


# --- models of the level-0 and large-block kernels (csrc/synth.cu) ---------


def _level0_model(k, vals, *, k_addr, pcm_addr):
    """synth_level0_kernel's grid in torch: level0_plan's (vec, tx, ty),
    thread (x, y) of CTA (bx, by) converting vector bx*tx... of block
    by*ty + y with that block's val. Every sample must be written once."""
    B, nb, rows, _ = k.shape
    n = rows
    vec, tx, ty = sc.level0_plan(n, k_addr, pcm_addr)
    assert n % vec == 0 and k_addr % (2 * vec) == 0 and tx * ty <= 256
    nblk = B * nb
    gx, gy = -(-nblk // ty), -(-(n // vec) // tx)
    kk = k.reshape(nblk, n).to(torch.int64)
    vv = vals.reshape(nblk).to(torch.int64)
    out = torch.zeros((nblk, n), dtype=torch.int64)
    hits = torch.zeros((nblk, n), dtype=torch.int64)
    blk = (torch.arange(gx)[:, None] * ty + torch.arange(ty)[None]).reshape(-1)
    v = (torch.arange(gy)[:, None] * tx + torch.arange(tx)[None]).reshape(-1)
    blk, v = blk[blk < nblk], v[v < n // vec]
    for i in range(vec):
        e = v * vec + i
        out[blk[:, None], e[None]] = kk[blk[:, None], e[None]] * vv[blk, None]
        hits[blk[:, None], e[None]] += 1
    assert bool((hits == 1).all())
    return _to_pcm(out & _M32, 0).reshape(B, nb, n)


@pytest.mark.parametrize("rows,nb,k_addr", [
    (2048, 5, 0), (2048, 3, 2), (2048, 2, 4), (2048, 1, 8), (256, 7, 0),
    (50, 9, 0), (3, 11, 0), (64, 40, 6), (1000, 2, 16)])
def test_level0_model_matches_plain(rows, nb, k_addr):
    """Vector widths 8, 4, 2, 1 by n and k's alignment, CTAs of several
    blocks where a block has fewer than 256 vectors."""
    k, v, w = _inputs(0, rows, 2, nb, seed=rows + nb)
    k, v, w = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(w)
    want, _ = st.synth_pcm_batch(k, v, w, level=0, rows=rows)
    got = _level0_model(k, v, k_addr=k_addr, pcm_addr=0)
    assert torch.equal(want, got)


def _fir_vec(a, m, c, pos, sh, bias):
    t = (a + c) & _M32
    y = torch.where(((pos >> sh) & 1) == 0, t + 2 * m, 2 * m - t) & _M32
    if bias:
        y = (y + ((pos & ((1 << sh) - 1)) == 0).to(torch.int64)) & _M32
    return y


def _large_model(k, vals, wrap0, *, level, rows, seed=0):
    """The route of blocks that fit no CTA, in torch: tail_pass(level)
    wide passes over each file's flat stream (4 outputs a thread, one val
    a vector), then synth_tail_kernel's tiles: TAIL_TILE outputs, a halo
    of tail_halo(level) inputs recomputed through every tail pass, wrap0
    put before the file's first tile for each pass, each pass's carry
    taken from the file's last tile, the buffers holding stale values
    (random here) outside what each pass writes."""
    B, nb = k.shape[:2]
    cols = 1 << level
    n, wlen = rows * cols, 2 * cols - 2
    L = nb * n
    TL, H, p0 = sc.TAIL_TILE, sc.tail_halo(level), sc.tail_pass(level)
    assert H <= TL and H % 4 == 0 and TL % 8 == 0
    kk = k.to(torch.int64).reshape(B, L)
    vv = vals.to(torch.int64)
    w0 = wrap0.to(torch.int64) & _M32
    wrapf = torch.zeros((B, wlen), dtype=torch.int64)
    pcm = torch.empty((B, L), dtype=torch.int16)
    rng = torch.Generator().manual_seed(seed)
    x = None
    for p in range(p0):  # wide passes: s % 4 == 0, n % 4 == 0
        sh = level - 1 - p
        s, off = 1 << sh, 2 * cols - 4 * (1 << sh)
        f = torch.arange(L)
        if p == 0:
            vec_blk = (f // 4 * 4) // n  # one val per vector of 4
            inp = (kk * vv[:, vec_blk]) & _M32
        else:
            inp = x
        ext = torch.cat([w0[:, off : off + 2 * s], inp], dim=1)
        x = _fir_vec(ext[:, 2 * s :], ext[:, s:-s], ext[:, : -2 * s], f, sh,
                     p == 0)
        wrapf[:, off : off + 2 * s] = inp[:, L - 2 * s :]
    for b in range(B):
        for t0 in range(0, L, TL):
            M = min(TL, L - t0)
            E = H + M
            bufs = [torch.randint(0, 1 << 32, (H + TL,), generator=rng,
                                  dtype=torch.int64) for _ in range(2)]
            src, dst = bufs
            pos = t0 - H + torch.arange(E)
            ok = pos >= 0
            src[:E] = 0
            if p0 == 0:
                src[:E][ok] = (kk[b, pos[ok]] * vv[b, pos[ok] // n]) & _M32
            else:
                src[:E][ok] = x[b, pos[ok]]
            for p in range(p0, level):
                sh = level - 1 - p
                s, off = 1 << sh, 2 * cols - 4 * (1 << sh)
                if t0 + M == L:
                    wrapf[b, off : off + 2 * s] = src[E - 2 * s : E]
                if t0 == 0:
                    src[H - 2 * s : H] = w0[b, off : off + 2 * s]
                j = torch.arange(H - 2 * s if p + 1 < level else H, E)
                y = _fir_vec(src[j], src[j - s], src[j - 2 * s], t0 - H + j,
                             sh, p == 0)
                if p + 1 < level:
                    dst[j] = y
                    src, dst = dst, src
                else:
                    pcm[b, t0 : t0 + M] = _to_pcm(y, level)
    wrapf = torch.where(wrapf >= 1 << 31, wrapf - (1 << 32), wrapf)
    return pcm.reshape(B, nb, n), wrapf.to(torch.int32)


@pytest.mark.parametrize("level,rows,B,nb,stride,tile", [
    (6, 3, 2, 5, 4, 32),  # three wide passes, tiles cut mid-block
    (4, 3, 2, 3, 4, 32),  # L % TL != 0: a short last tile
    (3, 5, 2, 3, 4, 16),  # no wide pass: the tail reads k (p0 == 0)
    (1, 5, 2, 3, 4, 8),  # level 1: n % 4 == 2, the tail's only pass is 0
    (7, 1, 1, 6, 8, 32), (5, 2, 3, 2, 2, 8),  # rows == 1; H == TL
    (14, 1, 1, 2, None, None), (11, 16, 1, 1, None, None),  # real sizes
    (15, 16, 1, 1, None, None), (12, 9, 2, 1, None, None),
])
def test_large_block_model_matches_plain(monkeypatch, level, rows, B, nb,
                                         stride, tile):
    """The wide passes and the tail's tiles with a recomputed halo, held
    to the plain version: at the kernel's constants on blocks over 227 KB,
    and with a smaller tail stride and tile on small blocks (the same
    index math)."""
    if stride:
        monkeypatch.setattr(sc, "TAIL_STRIDE", stride)
        monkeypatch.setattr(sc, "TAIL_TILE", tile)
    else:
        assert sc.route(level, rows, nb).endswith("synth_tail")
    k, v, w = _inputs(level, rows, B, nb, seed=level * 5 + rows)
    k, v, w = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(w)
    want_pcm, want_w = st.synth_pcm_batch(k, v, w, level=level, rows=rows)
    got_pcm, got_w = _large_model(k, v, w, level=level, rows=rows)
    assert torch.equal(want_pcm, got_pcm)
    assert torch.equal(want_w, got_w)


@pytest.mark.parametrize("level,rows,nb,launches", [
    (0, 2048, 416, {"synth_level0": 1}), (7, 1, 4800, {"synth_fused": 1}),
    (13, 2, 4, {"synth_fused": 1}), (11, 16, 2, {"synth_tail": 1}),
    (14, 1, 4, {"synth_pass": 3, "synth_tail": 1}),
    (15, 16, 3, {"synth_pass": 4, "synth_tail": 1}),
])
def test_kernel_launches_by_geometry(level, rows, nb, launches):
    """Level 0 and every block that fits a CTA: one launch; larger
    blocks: one flat launch per pass wider than TAIL_STRIDE, one tail."""
    assert sc.kernel_launches(level, rows, nb) == launches
    assert sc.route(level, rows, nb) == "+".join(launches)
    assert sc.tail_halo(15) <= sc.TAIL_TILE
    assert 2 * (sc.tail_smem_bytes(15) + sc.CTA_RESERVED) <= sc.SM_SMEM
