"""The cols-wire unpack: the port's plain version and a torch model of the
CUDA kernel's schedule ≡ the JAX package's unpack, at tolerance 0.

The JAX side is the device work of `libacm_tpu/ops/synth_jax.py::
synth_pcm_cols_blob` before its filterbank: the blob sliced at
`cols_blob_layout`, the 2-bit class-code expansion, `ops/packing.py::
unpack_columns` and `_bytes_le`. The port's `synth_torch.unpack_cols_blob`
takes its plain version (`unpack_cols_blob_plain`) for a CPU blob; on a
card it launches `csrc/unpack.cu`, which `_unpack_model` replays here:
column tiles of unpack_cuda.TC, their family counts and width tiles of
unpack_cuda.WT nibbles with in-tile prefixes (the reduce), exclusive scans
of both kinds of tile totals (the scan), then per (tile, run of rows) the
packed in-tile ranks, ordinals, widths, bit offsets, clamped word reads
and rows-major writes (the values). The inputs are scanner wires
(`_chunk_wire`, as tests/test_torch_packing.py makes them) and synthetic
wires with the edges a scanner does not make (bench_torch.UNPACK_EDGES,
which chip_smoke.py also drives). The kernel itself is held to the plain
version on the card in tests/test_torch_cuda.py.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libacm_tpu.ops import packing as jpacking
from libacm_tpu.ops import synth_jax as sj
from libacm_tpu.scan import oracle as joracle
from libacm_tpu_torch.ops import synth_torch as st
from libacm_tpu_torch.ops import unpack_cuda as uc
from libacm_tpu_torch.parallel.corpus import _coalesce_wire
from libacm_tpu_torch.scan import native as tnative
from libacm_tpu_torch.scan import oracle as toracle
from test_torch_packing import WIRE_GEOMETRIES, _chunk_files, _chunk_wire

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_torch  # noqa: E402  (the synthetic wires: one definition)

FIXTURES = ROOT / "tests" / "fixtures"
FIELD = 21  # bits per family in the kernel's packed in-tile counts


# -- the JAX package's unpack -------------------------------------------------


def _jax_unpack(blob, level, rows, batch, nb, lens, has_wrap):
    """(k, vals, wrap0 or None) as numpy, by the JAX package's functions."""
    cols = 1 << level
    secs, total = sj.cols_blob_layout(level, batch, nb, lens,
                                      has_wrap=has_wrap)
    assert blob.shape == (total,)
    parts = [jnp.asarray(blob[o: o + n]) for o, n in secs]
    cls = parts[0].reshape(batch, nb, (cols + 3) // 4)
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2  # synth_jax.py:224-231
    codes = ((cls[..., None] >> shifts) & 3).reshape(batch, nb, -1)[..., :cols]
    k_cols = jpacking.unpack_columns(codes.reshape(batch * nb * cols),
                                     *parts[1:7], rows=rows)
    k = np.asarray(k_cols).reshape(batch, nb, cols, rows).transpose(0, 1, 3, 2)
    vals = np.asarray(sj._bytes_le(parts[7], 2, jnp.uint16)).astype(np.int32)
    wrap0 = (np.asarray(sj._bytes_le(parts[8], 4, jnp.int32)).reshape(
        batch, 2 * cols - 2) if has_wrap else None)
    return k, vals.reshape(batch, nb), wrap0


# -- a model of csrc/unpack.cu ------------------------------------------------

#: the model's global memory: random bytes around the blob, which starts
#: `align` bytes past a 16-byte boundary (a blob that is a view)
PAD = 32
#: the status words' epoch in the model, and the ticket count before it
#: (the 32-bit counter wraps during the call)
EPOCH, TICKET0 = 7, (1 << 32) - 5


def _status(flag, value):
    assert 0 <= value < 1 << uc.VBITS
    return (EPOCH << uc.EPOCH_SHIFT) | (flag << uc.VBITS) | value


def _ready(word, need):
    """(ready, flag, value) of a status word for a reader that needs a
    flag of at least `need` (1 aggregate, 2 inclusive) in this epoch."""
    flag = (word >> uc.VBITS) & 3
    ok = word >> uc.EPOCH_SHIFT == EPOCH and flag >= need
    return ok, flag, word & ((1 << uc.VBITS) - 1)


def _wait(st, i, need):
    """Generator: yields "wait" until st[i] is ready; returns its value."""
    while True:
        ok, _, v = _ready(st[i], need)
        if ok:
            return v
        yield "wait"


def _lookback(st, lo, idx):
    """Generator: the warp's look-back, 32 predecessors a window, nearest
    first, back to the nearest inclusive word; returns the sum."""
    excl, end = 0, idx
    while end > lo:
        got = []
        for lane in range(32):
            p = end - 1 - lane
            if p < lo:
                got.append((2, 0))
                continue
            while not _ready(st[p], 1)[0]:
                yield "wait"
            got.append(_ready(st[p], 1)[1:])
        inc = [lane for lane, (flag, _) in enumerate(got) if flag == 2]
        stop = inc[0] if inc else 31
        excl += sum(v for _, v in got[: stop + 1])
        if inc:
            return excl
        end -= 32
    return excl


def _stage(start, end, pay, plen):
    """A family's span of stream bits [start, end) in shared memory, as
    csrc/unpack.cu stages it from a payload of plen bytes at address pay:
    (a: the stream byte at the buffer's start, 16-byte aligned in memory
    and rounded down; blen: its bytes, up to 8 past the last word a value
    reads; nchunk: the 16-byte copies, none past the payload's last
    16-byte granule; fill: whether bytes past the payload are filled
    with its last word)."""
    need_lo, need_hi = (start >> 4) * 2, (end >> 3) + 8
    a = need_lo - ((pay + need_lo) & 15)
    blen = (need_hi - a + 15) & ~15
    copy_hi = min(need_hi, plen)
    nchunk = -(-(copy_hi - a) // 16) if copy_hi > a else 0
    return a, blen, nchunk, need_hi > plen


def _packed(x, f):
    return (x >> (FIELD * f)) & ((1 << FIELD) - 1)


def _unpack_model(blob, level, rows, batch, nb, lens, has_wrap,
                  order="ticket", align=0, seed=0):
    """csrc/unpack.cu's one launch replayed in torch (numpy blob in, k,
    vals, wrap0 out), at the kernel's plan: CTAs by ticket (width tiles,
    column tiles, the conversion), status words with epochs (stale words
    of the last epoch in the buffer), the look-back, NP at each tile's
    first ordinal, the staged spans with the clamp fill, funnel-shift
    reads from the 32-bit shared words and 8-element stores into flat k.
    order="ticket" runs each CTA to its end in ticket order (none may
    wait); "shuffled" keeps a few CTAs resident and steps a random one,
    so the look-back resolves in another order of completion."""
    p = uc.plan(level, rows, batch, nb, lens, has_wrap)
    rng = np.random.default_rng(seed)
    cols = 1 << level
    off = [o for o, _ in p["secs"]]
    ltc = p["ltc"]
    tc = 1 << ltc
    n, nct, WT = p["ncols"], p["nct"], uc.WT
    nwt_all = sum(p["nwt"])
    mem = np.concatenate([rng.integers(0, 256, PAD + align, dtype=np.uint8),
                          blob, rng.integers(0, 256, PAD, dtype=np.uint8)])
    g0 = PAD + align  # the blob's address
    b = torch.from_numpy(blob).to(torch.int64)
    k = torch.full((batch * nb * rows * cols,), -1, dtype=torch.int64)
    written = torch.zeros_like(k)
    vals = torch.full((batch * nb,), -1, dtype=torch.int64)
    wrap0 = torch.full((p["nwrap"],), -1, dtype=torch.int64)

    # the scratch: word 0 the ticket counter, then width and column words,
    # stale words of the last epoch among them
    st = [int(x) for x in rng.integers(0, 1 << 38, 1 + nwt_all + 3 * nct)]
    st = [((EPOCH - 1) << uc.EPOCH_SHIFT) | (1 << uc.VBITS) | x for x in st]
    st[0] = TICKET0
    cst = 1 + nwt_all  # the first column status word

    col = torch.arange(n)
    byte = b[off[0] + (col >> level) * p["stride"] + ((col & (cols - 1)) >> 2)]
    code = (byte >> (((col & (cols - 1)) & 3) * 2)) & 3

    def wid_nib(f, o):  # nib(o), the byte index clamped to L-1
        L = lens[3 + f]
        wb = b[off[4 + f] + torch.clamp(o >> 1, max=L - 1)]
        return (wb >> ((o & 1) * 4)) & 15

    def width_tile(wb):
        f = 0 if wb < p["nwt"][0] else 1 if wb < p["nwt"][0] + p["nwt"][1] else 2
        j = wb - p["wbase"][f]
        L = lens[3 + f]
        o = torch.arange(j * WT, min((j + 1) * WT, 2 * L))
        tot = int(wid_nib(f, o).sum())
        st[1 + wb] = _status(2 if j == 0 else 1, tot)
        yield "step"
        if j:
            ex = yield from _lookback(st, 1 + p["wbase"][f], 1 + wb)
            st[1 + wb] = _status(2, ex + tot)

    def column_tile(t):
        c0 = t << ltc
        ncol = min(tc, n - c0)
        cd = code[c0: c0 + ncol]
        mine = torch.where(cd > 0, 1 << (FIELD * (cd - 1).clamp(min=0)), 0)
        tot = int(mine.sum())
        rank = mine.cumsum(0) - mine
        live = [f for f in range(3) if p["present"][f]]
        for f in live:
            st[cst + f * nct + t] = _status(2 if t == 0 else 1, _packed(tot, f))
        yield "step"
        o0 = {}
        for f in live:
            lo = cst + f * nct
            o0[f] = (yield from _lookback(st, lo, lo + t)) if t else 0
            if t:
                st[lo + t] = _status(2, o0[f] + _packed(tot, f))
        # NP(o0): the width tile before o0's inclusive prefix, the nibbles
        # before o0 inside its tile, the clamp past 2L
        np0 = {}
        mine_f = [f for f in live if _packed(tot, f)]
        for f in mine_f:
            L = lens[3 + f]
            P = min(o0[f], 2 * L)
            j = P // WT
            part = int(wid_nib(f, torch.arange(j * WT, P)).sum())
            excl = (yield from _wait(st, 1 + p["wbase"][f] + j - 1, 2)) if j else 0
            last = int(b[off[4 + f] + L - 1])
            e = o0[f] - P
            np0[f] = excl + part + (e >> 1) * ((last & 15) + (last >> 4)) + (
                e & 1) * (last & 15)
        # widths and their in-tile prefix per family (packed)
        w = torch.zeros(ncol, dtype=torch.int64)
        for f in mine_f:
            sel = cd == f + 1
            w[sel] = wid_nib(f, o0[f] + _packed(rank[sel], f)) + 1
        wmine = torch.where(w > 0, w << (FIELD * (cd - 1).clamp(min=0)), 0)
        wtot = int(wmine.sum())
        wpre = wmine.cumsum(0) - wmine
        # the spans, staged; bytes past the payload read as its last word
        smem = rng.integers(0, 256, p["smem"], dtype=np.uint8)
        span = {}
        sbase = 0
        for f in mine_f:
            start = rows * (o0[f] + np0[f])
            end = start + rows * _packed(wtot, f)
            pay, plen = g0 + off[1 + f], lens[f]
            a, blen, nchunk, _ = _stage(start, end, pay, plen)
            src = pay + a
            assert src % 16 == 0  # and the copy stays in the blob's granules
            assert not nchunk or (src >= g0 & ~15 and src + 16 * nchunk
                                  <= -(-(g0 + len(blob)) // 16) * 16)
            smem[sbase: sbase + 16 * nchunk] = mem[src: src + 16 * nchunk]
            hlast = int(blob[off[1 + f] + plen - 2]) | int(
                blob[off[1 + f] + plen - 1]) << 8
            for sb in range(max(plen, a), a + blen):
                smem[sbase + sb - a] = (hlast >> ((sb & 1) * 8)) & 255
            span[f] = (start, a, sbase)
            sbase += blen
        assert sbase <= p["span"], "spans overflow their shared memory"
        tab = torch.from_numpy(rng.integers(0, 1 << 32, tc, dtype=np.int64))
        ent = torch.zeros(ncol, dtype=torch.int64)
        for f in mine_f:
            sel = (cd == f + 1) & (w > 0)
            start, a, sb0 = span[f]
            s = 8 * sb0 + (start + rows * _packed(wpre[sel], f) - 8 * a)
            assert bool((s < 1 << 27).all())
            ent[sel] = (s << 5) | w[sel]
        tab[:ncol] = ent
        s32 = torch.from_numpy(smem[: p["span"]].view("<u4").astype(np.int64))

        def value_at(e, r):
            wv = e & 31
            s = ((e >> 5) + r * wv) & 0xFFFFFFFF
            lo, hi = s32[s >> 5], s32[(s >> 5) + 1]
            win = ((hi << 32 | lo) >> (s & 31)) & 0xFFFFFFFF
            sh = (32 - wv) & 31
            v = ((win << sh) & 0xFFFFFFFF)
            v = torch.where(v >= 1 << 31, v - (1 << 32), v) >> sh
            return torch.where(wv > 0, v, 0)

        # the values: 8 consecutive elements of the tile's flat k run
        nel = ncol * rows
        lsw = min(ltc, level)
        if lsw >= 3:
            obase = ((c0 >> level) * rows << level) + (c0 & (cols - 1))
            i = torch.arange(nel >> 3)  # item: row r of 8 columns, rows fastest
            gi = (i * p["magic"]) >> 32
            assert torch.equal(gi, i // rows)
            r = i - gi * rows
            bl, c = gi >> (lsw - 3), (gi & ((1 << (lsw - 3)) - 1)) << 3
            q = bl * rows + r
            lc = (bl << lsw) + c
            out = obase + (q << level) + c
            assert bool((out % 8 == 0).all()), "a store not 16-byte aligned"
            for j in range(8):
                k[out + j] = value_at(tab[lc + j], r)
                written.index_add_(0, out + j, torch.ones_like(out))
        else:
            E0 = c0 * rows
            gi = torch.arange(E0 >> 3, (E0 + nel + 7) >> 3)
            for j in range(8):
                e = (gi << 3) - E0 + j
                e = e[(e >= 0) & (e < nel)]
                q, c = e >> level, e & (cols - 1)
                bl = (q * p["magic"]) >> 32
                r = q - bl * rows
                k[E0 + e] = value_at(tab[(bl << level) + c], r)
                written.index_add_(0, E0 + e, torch.ones_like(e))

    def convert(i):
        pv = b[off[7]: off[7] + 2 * p["nvals"]].reshape(-1, 2)
        for x in range(i * uc.THREADS, p["nvals"] + p["nwrap"],
                       p["nvw"] * uc.THREADS):
            for y in range(x, min(x + uc.THREADS, p["nvals"] + p["nwrap"])):
                if y < p["nvals"]:
                    vals[y] = pv[y, 0] | pv[y, 1] << 8
                else:
                    q = off[8] + 4 * (y - p["nvals"])
                    u = b[q] | b[q + 1] << 8 | b[q + 2] << 16 | b[q + 3] << 24
                    wrap0[y - p["nvals"]] = u - (1 << 32) if u >= 1 << 31 else u
        yield "step"

    def cta():
        ticket = (st[0] - TICKET0) % (1 << 32)
        st[0] = (st[0] + 1) % (1 << 32)
        if ticket < nwt_all:
            return width_tile(ticket)
        if ticket < nwt_all + nct:
            return column_tile(ticket - nwt_all)
        return convert(ticket - nwt_all - nct)

    if order == "ticket":
        for _ in range(p["grid"]):
            assert "wait" not in list(cta()), "a tile waited on a later one"
    else:
        running, started, steps = [], 0, 0
        while started < p["grid"] or running:
            if started < p["grid"] and len(running) < 4 and (
                    not running or rng.random() < 0.4):
                running.append(cta())
                started += 1
                continue
            i = int(rng.integers(len(running)))
            try:
                next(running[i])
            except StopIteration:
                running.pop(i)
            steps += 1
            assert steps < 100 * p["grid"] + 10_000, "the look-back stalled"
    assert (st[0] - TICKET0) % (1 << 32) == p["grid"]
    assert bool((written == 1).all()), "a value written twice or never"
    k = k.to(torch.int16).reshape(batch, nb, rows, cols)
    vals = vals.to(torch.int32).reshape(batch, nb)
    wrap0 = wrap0.to(torch.int32).reshape(batch, 2 * cols - 2) if has_wrap else None
    return k, vals, wrap0


# -- wires --------------------------------------------------------------------


def _scanner_wire(files, level, rows, nb, wrap_seed):
    """A scanner chunk's coalesced blob, wrap0 from a seed."""
    w = _chunk_wire(tnative, toracle, files, level, rows, nb)
    cols = 1 << level
    rng = np.random.default_rng(wrap_seed)
    wrap0 = rng.integers(-(1 << 31), 1 << 31, (len(files), 2 * cols - 2),
                         dtype=np.int64).astype(np.int32)
    blob, lens = _coalesce_wire((w["cls"], w["pay4"], w["pay8"], w["pay16"],
                                 w["wid4"], w["wid8"], w["wid16"], w["vals"],
                                 wrap0))
    return blob.copy(), level, rows, len(files), nb, lens, True


def _as_tuple(w):
    return (w["blob"], w["level"], w["rows"], w["batch"], w["nb"], w["lens"],
            w["has_wrap"])


def _edge_wire(name):
    return _as_tuple(bench_torch.edge_wire(name))


def _geometry_wire(level, rows, n_blocks):
    files = _chunk_files(level, rows, n_blocks, seed=level * 100 + rows + 2)
    return _scanner_wire(files, level, rows, n_blocks + 3, level)


def _fixture_wire(name):
    data = (FIXTURES / name).read_bytes()
    h = toracle.parse_header(toracle.BitReader(data))
    assert joracle.parse_header(joracle.BitReader(data)) is not None
    return _scanner_wire([data], h.level, h.rows, max(h.n_blocks, 1),
                         len(name))


WIRES = ([(f"scanner {lv}/{rw} x {n}",
           lambda g=(lv, rw, n): _geometry_wire(*g))
          for lv, rw, n in WIRE_GEOMETRIES]
         + [(f"fixture {p.name}", lambda n=p.name: _fixture_wire(n))
            for p in sorted(FIXTURES.glob("*.acm"))])
EDGE_WIRES = [(f"edge: {name}", lambda n=name: _edge_wire(n))
              for name in bench_torch.UNPACK_EDGES]
EDGE_WIRES += [(f"random wire {seed}", lambda s=seed: _as_tuple(
    bench_torch.random_wire(s))) for seed in range(6)]

_JAX = {}


def _want(key, wire):
    if key not in _JAX:
        _JAX[key] = _jax_unpack(*wire)
    return _JAX[key]


def _assert_same(got, want):
    k, vals, wrap0 = got
    np.testing.assert_array_equal(np.asarray(k.numpy()), want[0], err_msg="k")
    assert k.dtype == torch.int16 and k.is_contiguous()
    np.testing.assert_array_equal(vals.numpy(), want[1], err_msg="vals")
    assert vals.dtype == torch.int32
    if want[2] is None:
        assert wrap0 is None
    else:
        assert wrap0.dtype == torch.int32
        np.testing.assert_array_equal(wrap0.numpy(), want[2], err_msg="wrap0")


def _run(impl, wire):
    blob, level, rows, batch, nb, lens, has_wrap = wire
    if impl == "model":
        return _unpack_model(blob, level, rows, batch, nb, lens, has_wrap)
    if impl == "model shuffled":  # another order of completion, a view blob
        return _unpack_model(blob, level, rows, batch, nb, lens, has_wrap,
                             order="shuffled", align=7, seed=len(blob))
    return st.unpack_cols_blob(torch.from_numpy(blob), level=level, rows=rows,
                               batch=batch, nb=nb, lens=lens,
                               has_wrap=has_wrap)


# -- (a) the plain version and (b) the kernel's model, against JAX ------------


@pytest.mark.parametrize("impl", ["plain", "model", "model shuffled"])
@pytest.mark.parametrize("key,make", WIRES + EDGE_WIRES,
                         ids=[k for k, _ in WIRES + EDGE_WIRES])
def test_unpack_matches_jax(key, make, impl):
    wire = make()
    _assert_same(_run(impl, wire), _want(key, wire))


@pytest.mark.parametrize("key,make", WIRES, ids=[k for k, _ in WIRES])
def test_cols_blob_pcm_matches_jax(key, make):
    """The plain unpack feeds the filterbank: the blob's PCM and final
    carry equal the JAX package's synth_pcm_cols_blob."""
    blob, level, rows, batch, nb, lens, _ = make()
    want_pcm, want_w = sj.synth_pcm_cols_blob(
        jnp.asarray(blob), level=level, rows=rows, batch=batch, nb=nb,
        lens=lens)
    got_pcm, got_w = st.synth_pcm_cols_blob(
        torch.from_numpy(blob), level=level, rows=rows, batch=batch, nb=nb,
        lens=lens)
    np.testing.assert_array_equal(np.asarray(want_pcm), got_pcm.numpy())
    if level:
        np.testing.assert_array_equal(np.asarray(want_w), got_w.numpy())


# -- the dispatch and the launch plan -----------------------------------------


def test_cpu_blob_takes_the_plain_version(monkeypatch):
    wire = _edge_wire("rows == 1")
    blob, level, rows, batch, nb, lens, has_wrap = wire
    calls = []
    plain = st.unpack_cols_blob_plain
    monkeypatch.setattr(st, "unpack_cols_blob_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    uc.reset_launches()
    got = st.unpack_cols_blob(torch.from_numpy(blob), level=level, rows=rows,
                              batch=batch, nb=nb, lens=lens,
                              has_wrap=has_wrap)
    assert calls == [1] and sum(uc.launches.values()) == 0
    _assert_same(got, _jax_unpack(*wire))


def test_other_devices_raise():
    blob = torch.zeros(st.cols_blob_layout(3, 1, 2, (0,) * 6)[1],
                       dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no unpack kernel for device meta"):
        st.unpack_cols_blob(blob, level=3, rows=4, batch=1, nb=2,
                            lens=(0,) * 6, has_wrap=True)


def test_plain_version_rejects_a_wrong_blob_length():
    blob, level, rows, batch, nb, lens, has_wrap = _edge_wire("rows == 1")
    with pytest.raises(ValueError, match="layout needs"):
        st.unpack_cols_blob(torch.from_numpy(blob[:-1]), level=level,
                            rows=rows, batch=batch, nb=nb, lens=lens,
                            has_wrap=has_wrap)


def test_synth_pcm_cols_blob_dispatches_the_unpack(monkeypatch):
    """synth_pcm_cols_blob unpacks through unpack_cols_blob, whatever the
    filterbank backend."""
    blob, level, rows, batch, nb, lens, _ = _edge_wire("rows == 1")
    seen = []
    real = st.unpack_cols_blob
    monkeypatch.setattr(st, "unpack_cols_blob",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    for backend in ("torch", "cuda"):
        st.synth_pcm_cols_blob(torch.from_numpy(blob), level=level, rows=rows,
                               batch=batch, nb=nb, lens=lens, backend=backend)
    assert len(seen) == 2 and all(kw["has_wrap"] for kw in seen)


@pytest.mark.parametrize("level,rows,batch,nb,has_wrap,want", [
    (7, 16, 25, 320, True, 1), (0, 2048, 5, 416, True, 1),
    (7, 16, 1, 2048, False, 1), (7, 16, 2, 0, True, 1),
    (7, 16, 2, 0, False, 0), (0, 9, 2, 0, True, 0), (4, 3, 0, 5, True, 0),
])
def test_unpack_launches(level, rows, batch, nb, has_wrap, want):
    got = uc.unpack_launches(level, batch, nb, has_wrap)
    assert sum(got.values()) == want and set(got) <= set(uc.launches)


@pytest.mark.parametrize("level,rows,batch,nb,tiles,tc", [
    (7, 16, 25, 320, 500, 2048), (4, 40, 15, 1216, 570, 512),
    (0, 2048, 5, 416, 520, 4), (7, 16, 1, 8, 8, 128), (7, 16, 1, 2048, 512, 512),
    (10, 4, 10, 160, 800, 2048), (15, 1, 1, 1, 16, 2048),
])
def test_plan_sizes_tiles_by_values(level, rows, batch, nb, tiles, tc):
    """Column tiles of about TILE_VALUES values (a power of two of
    columns, at most TC_MAX), halved for short calls down to
    MIN_TILE_VALUES; the worst-case span (16 bits a value) and the
    per-column table fit the shared memory the launch asks for."""
    p = uc.plan(level, rows, batch, nb, (0,) * 6, True)
    assert p["nct"] == tiles and 1 << p["ltc"] == tc
    assert tc * rows <= max(uc.TILE_VALUES, 8 * rows)
    assert (tiles >= uc.TARGET_TILES or tc * rows <= uc.MIN_TILE_VALUES
            or tc == min(1 << level, 8))
    assert p["span"] >= 2 * tc * rows and p["smem"] == p["span"] + 4 * tc
    assert p["smem"] <= 227 * 1024 and p["span"] % 16 == 0  # Hopper's cap
    assert p["grid"] == sum(p["nwt"]) + tiles + p["nvw"]


def test_geometry_matches_the_kernels_layout():
    """The 40 long longs in csrc/unpack.cu's geo_from order."""
    lens = (10, 4, 0, 3, 2, 0)
    p = uc.plan(5, 7, 2, 3, lens, True)
    g = list(uc.geometry(p, 5, 7, epoch=9, ticket0=123))
    secs = p["secs"]
    assert len(g) == 40
    assert g[:9] == [o for o, _ in secs] and g[9:18] == [n for _, n in secs]
    assert g[18:23] == [2 * 3 * 32, 5, 7, 8, p["nct"]]
    assert g[23:26] == [1, 1, 0] and g[26:29] == [1, 1, 0]
    assert g[29:32] == [0, 1, 2]
    assert g[32:36] == [6, 2 * 62, 1, p["ltc"]]
    assert g[36:40] == [p["span"], -(-(1 << 32) // 7), 9, 123]
    src = (pathlib.Path(uc.__file__).parent.parent / "csrc" / "unpack.cu"
           ).read_text()
    for const in (f"WT = {uc.WT};", f"TC_MAX = {uc.TC_MAX};",
                  f"THREADS = {uc.THREADS};", f"FIELD = {uc.FIELD};",
                  f"VBITS = {uc.VBITS};", f"EPOCH_SHIFT = {uc.EPOCH_SHIFT};"):
        assert const in src, const


def test_geometry_carries_64_bit_offsets():
    """Sections past 2^31 bytes keep their offsets in the geometry, and a
    tile whose span starts past 2^31 bits stages to 32-bit shared
    offsets (the model's staging, on the geometry alone)."""
    lens = (3 << 30, 2, 2, 2, 1, 1)
    p = uc.plan(3, 16, 1, 4, lens, False)
    g = list(uc.geometry(p, 3, 16, epoch=1, ticket0=0))
    assert g[2] == p["secs"][2][0] > 1 << 31 and g[9 + 1] == 3 << 30
    start = (1 << 31) + 12345
    for pay in (0, 7, 1 << 33):
        a, blen, nchunk, fill = _stage(start, start + 16 * 16 * 512, pay,
                                       3 << 29)
        assert (pay + a) % 16 == 0 and 0 <= start // 8 - a < 32
        assert blen % 16 == 0 and blen <= 2 * 16 * 512 + 48
        assert nchunk * 16 <= blen and not fill
        assert 8 * blen < 1 << 27  # every shared bit offset fits the table
    # a span past the payload's end: nothing copied, all of it the last word
    a, blen, nchunk, fill = _stage(start, start + 64, 3, 100)
    assert nchunk == 0 and fill


@pytest.mark.parametrize("name", [
    "level 0, rows 2048", "padding codes at level 1", "rows == 1",
    "several tiles of several width tiles", "N not a multiple of a tile",
    "a tile with no non-zero column", "0/2048, 40 blocks"])
def test_model_at_full_tiles(name, monkeypatch):
    """Tiles of TILE_VALUES values where the short-call halving would cut
    them (0/2048 x 40 blocks: tiles of 16 blocks, the last one short):
    the model still equals the JAX package's unpack."""
    monkeypatch.setattr(uc, "TARGET_TILES", 0)
    wire = (_as_tuple(bench_torch.synthetic_wire(19, 0, 2048, 2, 20))
            if name == "0/2048, 40 blocks" else _edge_wire(name))
    p = uc.plan(*wire[1:])
    assert (1 << p["ltc"]) * wire[2] > uc.MIN_TILE_VALUES or p["ltc"] == 11
    if name == "0/2048, 40 blocks":
        assert p["nct"] == 3 and p["ltc"] == 4
    _assert_same(_unpack_model(*wire, order="shuffled", seed=3),
                 _want(f"full tiles: {name}", wire))


def test_scratch_epochs_and_tickets():
    """One status buffer per (device, stream): zeroed when made, a new
    epoch each call, grown (zeroed, epochs from 1) when a call needs more
    words, and zeroed again before the epochs would wrap."""
    dev = torch.device("cpu")
    uc._Scratch._by_key.pop((None, 12345), None)
    s = uc._Scratch.take(dev, 12345, 10)
    assert s.epoch == 1 and s.tickets == 0
    assert s.words.numel() == uc.SCRATCH_WORDS and not bool(s.words.any())
    s.tickets += 40
    assert uc._Scratch.take(dev, 12345, 10) is s and s.epoch == 2
    assert uc._Scratch.take(dev, 54321, 10) is not s
    s.words[0] = 99
    s.epoch = uc.EPOCHS - 1
    assert uc._Scratch.take(dev, 12345, 10) is s
    assert (s.epoch, s.tickets) == (1, 0) and not bool(s.words.any())
    big = uc._Scratch.take(dev, 12345, uc.SCRATCH_WORDS + 1)
    assert big is not s and big.words.numel() == uc.SCRATCH_WORDS + 1
    assert big.epoch == 1
    for key in ((None, 12345), (None, 54321)):
        uc._Scratch._by_key.pop(key)


# -- the bench's capture, bound and shapes for the unpack rows ----------------


def test_capture_wires_records_each_call_and_restores():
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import decode_corpus_device

    rng = np.random.default_rng(4)
    files = [testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=5)
             for _ in range(5)]
    real = st.unpack_cols_blob
    with bench_torch.capture_wires() as wires:
        dc = decode_corpus_device(files, device="cpu", chunk_files=2)
        dc.block_until_ready()
    assert st.unpack_cols_blob is real
    assert len(wires) == len(dc._buckets) == 3
    for w in wires:
        kw = bench_torch.wire_args(w)
        assert kw["level"] == 4 and kw["has_wrap"] is True
        want = _jax_unpack(w["blob"].numpy(), **kw)
        _assert_same(st.unpack_cols_blob(w["blob"], **kw), want)


def test_unpack_bound_counts_the_wire_and_its_nonzero_columns():
    w = bench_torch.edge_wire("family absent (payload < 2 bytes)")
    level, rows, batch, nb = 4, 9, 2, 5
    cols = 1 << level
    cm = w["blob"][: batch * nb * 4]
    codes = ((cm[:, None] >> (np.arange(4) * 2)) & 3).reshape(-1)
    nz = int((codes == 3).sum())  # families 1 and 2 are absent
    ms, by = bench_torch.unpack_bound(w)
    nbytes = (w["blob"].size + 2 * batch * nb * rows * cols + 4 * batch * nb
              + 4 * batch * (2 * cols - 2))
    ops = 4 * nz * rows + 4 * batch * nb * cols
    assert by == "bytes"
    assert ms == nbytes / bench_torch.HBM_BYTES_PER_S * 1e3
    assert ops / bench_torch.INT32_OPS_PER_S * 1e3 < ms
    same = dict(w, blob=torch.from_numpy(w["blob"]))  # a tensor blob too
    assert bench_torch.unpack_bound(same) == (ms, by)


def test_unpack_shapes_take_each_paths_wires():
    def wire(level, rows, batch, nb):
        return {"level": level, "rows": rows, "batch": batch, "nb": nb}

    wires = {"corpus": [wire(7, 16, 25, 320), wire(7, 16, 3, 320),
                        wire(0, 2048, 5, 416), wire(4, 40, 15, 1216)],
             "stream_window_2048": [wire(7, 16, 1, 2048)] * 3,
             "random_access": [wire(4, 40, 1, 8), wire(7, 16, 1, 16),
                               wire(7, 16, 1, 8), wire(7, 16, 1, 32),
                               wire(7, 16, 1, 8)]}
    got = bench_torch.unpack_shapes(wires, 2048)
    assert [(what, path, (w["level"], w["rows"], w["batch"], w["nb"]))
            for what, path, w in got] == [
        ("corpus chunk", "corpus", (7, 16, 25, 320)),
        ("corpus chunk", "corpus", (4, 40, 15, 1216)),
        ("corpus chunk", "corpus", (0, 2048, 5, 416)),
        ("stream window", "stream_window_2048", (7, 16, 1, 2048)),
        ("random-access segment", "random_access", (7, 16, 1, 8)),
        ("random-access segment", "random_access", (7, 16, 1, 32))]
    assert got[4][2] is wires["random_access"][2]
