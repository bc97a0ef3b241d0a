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


def _unpack_model(blob, level, rows, batch, nb, lens, has_wrap):
    """csrc/unpack.cu's three kernels replayed in torch (numpy blob in,
    k, vals, wrap0 out), at the kernel's tile sizes and launch plan."""
    p = uc.plan(level, rows, batch, nb, lens, has_wrap)
    TC, WT = uc.TC, uc.WT
    cols = 1 << level
    off = [o for o, _ in p["secs"]]
    b = torch.from_numpy(blob).to(torch.int64)
    n, nct = p["ncols"], p["nct"]
    k = torch.full((batch * nb * rows * cols,), -1, dtype=torch.int64)
    written = torch.zeros_like(k)

    # reduce: column-tile counts per family (padding codes belong to no
    # column), width tiles' in-tile inclusive prefixes and totals, vals
    # and wrap0 from bytes
    col = torch.arange(n)
    byte = b[off[0] + (col >> level) * p["stride"] + ((col & (cols - 1)) >> 2)]
    code = (byte >> (((col & (cols - 1)) & 3) * 2)) & 3
    tcnt = torch.zeros((3, nct), dtype=torch.int64)
    for f in range(3):
        tcnt[f].index_add_(0, col // TC, (code == f + 1).long())
    nploc, wsum = [], []
    for f in range(3):
        L = lens[3 + f]
        wid = torch.zeros(p["nwt"][f] * WT // 2, dtype=torch.int64)
        if p["present"][f]:
            wid[:L] = b[off[4 + f]: off[4 + f] + L]
        nib = torch.stack([wid & 15, wid >> 4], -1).reshape(p["nwt"][f], WT)
        nploc.append(nib.cumsum(1))
        wsum.append(nib.sum(1))
    pv = b[off[7]: off[7] + 2 * p["nvals"]].reshape(-1, 2)
    vals = (pv[:, 0] | pv[:, 1] << 8).to(torch.int32).reshape(batch, nb)
    wrap0 = None
    if has_wrap:
        pw = b[off[8]: off[8] + 4 * p["nwrap"]].reshape(-1, 4)
        u = pw[:, 0] | pw[:, 1] << 8 | pw[:, 2] << 16 | pw[:, 3] << 24
        wrap0 = torch.where(u >= 1 << 31, u - (1 << 32), u).to(
            torch.int32).reshape(batch, 2 * cols - 2)

    # scan: exclusive prefixes of both kinds of tile totals
    tpre = tcnt.cumsum(1) - tcnt
    wpre = [s.cumsum(0) - s for s in wsum]

    def nib_prefix(f, o):  # NP(o), the clamp past 2L included
        L = lens[3 + f]
        nn = 2 * L
        j = o.clamp(max=nn) - 1
        jc = j.clamp(min=0)
        np_ = wpre[f][jc // WT] + nploc[f][jc // WT, jc % WT]
        last = int(b[off[4 + f] + L - 1])
        e = (o - nn).clamp(min=0)
        lo, hi = last & 15, last >> 4
        np_ = np_ + (e >> 1) * (lo + hi) + (e & 1) * lo
        return torch.where(o == 0, 0, np_)

    # values: per CTA (tile t, run y of rows) rank the tile's columns, then
    # one thread per value over rows [r0, r0 + nr)
    lcw = min(level, 10)
    for t in range(nct):
        c0 = t * TC
        ncol = min(TC, n - c0)
        cd = code[c0: c0 + ncol]
        mine = torch.where(cd > 0, 1 << (FIELD * (cd - 1).clamp(min=0)), 0)
        rank = mine.cumsum(0) - mine
        s_w = torch.zeros(ncol, dtype=torch.int64)
        s_off = torch.zeros(ncol, dtype=torch.int64)
        s_f = torch.zeros(ncol, dtype=torch.int64)
        for f in range(3):
            sel = cd == f + 1
            if not p["present"][f] or not bool(sel.any()):
                continue
            L = lens[3 + f]
            o = tpre[f, t] + ((rank[sel] >> (FIELD * f)) & ((1 << FIELD) - 1))
            wb = b[off[4 + f] + (o >> 1).clamp(max=L - 1)]
            w = ((wb >> ((o & 1) * 4)) & 15) + 1
            s_w[sel] = w
            s_off[sel] = rows * (o + nib_prefix(f, o))
            s_f[sel] = f
        for y in range((rows + p["rs"] - 1) // p["rs"]):
            r0 = y * p["rs"]
            nr = min(p["rs"], rows - r0)
            idx = torch.arange(ncol * nr)
            seg = idx >> lcw
            r = r0 + seg % nr
            lc = ((seg // nr) << lcw) + (idx & ((1 << lcw) - 1))
            g = c0 + lc
            out = (((g >> level) * rows + r) << level) + (g & (cols - 1))
            w = s_w[lc]
            f = s_f[lc]
            nh = torch.tensor([lens[i] >> 1 for i in range(3)])[f]
            pay0 = torch.tensor(off[1:4])[f]
            bit = s_off[lc] + r * w
            i0 = torch.minimum(bit >> 4, nh - 1).clamp(min=0)
            i1 = torch.minimum((bit >> 4) + 1, nh - 1).clamp(min=0)
            hi = b.shape[0] - 1  # gathers of absent columns stay in range
            h0 = b[(pay0 + 2 * i0).clamp(max=hi)] | b[
                (pay0 + 2 * i0 + 1).clamp(max=hi)] << 8
            h1 = b[(pay0 + 2 * i1).clamp(max=hi)] | b[
                (pay0 + 2 * i1 + 1).clamp(max=hi)] << 8
            win = h0 | h1 << 16
            wv = w.clamp(min=1)
            u = (win >> (bit & 15)) & ((1 << wv) - 1)
            sign = 1 << (wv - 1)
            v = torch.where(w > 0, (u ^ sign) - sign, 0)
            k[out] = v
            written.index_add_(0, out, torch.ones_like(out))
    assert bool((written == 1).all()), "a value written twice or never"
    k = k.to(torch.int16).reshape(batch, nb, rows, cols)
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
    return st.unpack_cols_blob(torch.from_numpy(blob), level=level, rows=rows,
                               batch=batch, nb=nb, lens=lens,
                               has_wrap=has_wrap)


# -- (a) the plain version and (b) the kernel's model, against JAX ------------


@pytest.mark.parametrize("impl", ["plain", "model"])
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
    (7, 16, 25, 320, True, 3), (0, 2048, 5, 416, True, 3),
    (7, 16, 1, 2048, False, 3), (7, 16, 2, 0, True, 1),
    (7, 16, 2, 0, False, 0), (0, 9, 2, 0, True, 0), (4, 3, 0, 5, True, 0),
])
def test_unpack_launches(level, rows, batch, nb, has_wrap, want):
    got = uc.unpack_launches(level, batch, nb, has_wrap)
    assert sum(got.values()) == want and set(got) <= set(uc.launches)


@pytest.mark.parametrize("level,rows,batch,nb,tiles,runs", [
    (7, 16, 25, 320, 1000, 2), (4, 40, 15, 1216, 285, 4),
    (0, 2048, 5, 416, 3, 342), (7, 16, 1, 8, 1, 16), (7, 16, 1, 2048, 256, 4),
    (10, 4, 10, 160, 1600, 1), (15, 1, 1, 1, 32, 1),
])
def test_plan_cuts_tiles_into_runs_of_rows(level, rows, batch, nb, tiles,
                                           runs):
    """Column tiles of TC columns; a tile's rows cut into runs until about
    VALUE_CTAS CTAs (never more runs than rows)."""
    p = uc.plan(level, rows, batch, nb, (0,) * 6, True)
    assert p["nct"] == tiles
    assert -(-rows // p["rs"]) == runs
    assert tiles * runs >= min(uc.VALUE_CTAS, tiles * rows)


def test_geometry_matches_the_kernels_layout():
    """The 36 long longs in csrc/unpack.cu's geo_from order."""
    lens = (10, 4, 0, 3, 2, 0)
    p = uc.plan(5, 7, 2, 3, lens, True)
    g = list(uc.geometry(p, 5, 7))
    secs = p["secs"]
    assert len(g) == 36
    assert g[:9] == [o for o, _ in secs] and g[9:18] == [n for _, n in secs]
    assert g[18:23] == [2 * 3 * 32, 5, 7, 8, 1]
    assert g[23:26] == [1, 1, 0] and g[26:29] == [1, 1, 0]
    assert g[29:32] == [0, 1, 2]
    assert g[32:36] == [6, 2 * 62, 1, p["rs"]]
    src = (pathlib.Path(uc.__file__).parent.parent / "csrc" / "unpack.cu"
           ).read_text()
    for const in (f"TC = {uc.TC};", f"WT = {uc.WT};",
                  f"THREADS = {uc.THREADS};", f"FIELD = {FIELD};"):
        assert const in src, const


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
