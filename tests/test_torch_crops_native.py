"""read_batch's one native call (native.scan_crops, acm_scan_crops in
scan/_crops.cpp) against plain Python, on the CPU.

The call plans every crop of a batch, scans each span in place in its
clip's bytes and lays the wire and the metadata out in one blob; with a
null blob it plans alone, for the host route and for segment reads. Held
here, on seeded random files at a small size: its plan against the
test's own plain Python copy of it (the valid-word clamp, the warm-up
rule and the launch's block count), crop by crop and geometry by
geometry; the plan-only call's rows against the full call's; its blob,
byte for byte, against what the ingest path's scan
(native.scan_corpus_chunk over the spans staged back to back) and
corpus._coalesce_wire make of the same spans; the same errors on the card
and host routes; the host rows of a stale-amp-table file; the crop table
across the file LRU; a blob too small at first; and the counters a batch
records under a profiler.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from libacm_tpu_torch import testing
from libacm_tpu_torch.ops.synth_torch import cols_blob_layout
from libacm_tpu_torch.parallel import RandomAccessCorpus, build_index
from libacm_tpu_torch.parallel import corpus as tcorpus
from libacm_tpu_torch.parallel import random_access as ra
from libacm_tpu_torch.scan import native
from libacm_tpu_torch.utils import profiling

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native scanner did not build")

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
CPU = torch.device("cpu")
H, G, I = native.CROP_HEAD, native.CROP_GEOM, native.CROP_INFO

#: the geometries of test_torch_random_access_batch.py's
#: test_batch_of_one_geometry: (level, rows, blocks, channels)
GEOMETRIES = [(7, 16, 9, 1), (4, 40, 7, 1), (3, 1, 10, 1), (2, 1, 6, 1),
              (0, 64, 6, 1), (7, 16, 8, 2), (5, 33, 5, 2), (1, 2, 11, 1)]


def _plain_plan(idx, start: int, frames: int, ch: int) -> dict:
    """The plan acm_scan_crops makes of a crop, and the blocks a launch row
    needs for it, in plain Python: this test's own copy."""
    h = idx.header
    bl = h.block_len
    want = frames * ch
    end = min(h.total_values, idx.n_good * bl)
    sw = max(0, start * ch)
    stop = min(sw + want, end)
    valid = max(0, stop - sw)
    valid -= valid % ch
    if valid == 0 or idx.oor:
        return {"device": False, "sw": sw, "valid": valid}
    a = sw // bl
    b = -(-stop // bl)
    warm = 1 if (a > 0 and h.rows >= 2) else a
    a0 = a - warm
    nb = b - a0
    lo = sw - a0 * bl
    return {"device": True, "sw": sw, "valid": valid, "a0": a0, "nb": nb,
            "warm": warm, "lo": lo, "need": max(nb, -(-(lo + want) // bl)),
            "geo": (h.level, h.rows)}


def _native(rac, files, starts, frames, pad=True):
    entries = [rac._entry(i) for i in files]
    status, res, blob = ra._scan_crops(entries, starts, frames, pad, CPU)
    B = len(files)
    head = res[:H].tolist()
    geos = res[H : H + G * head[2]].reshape(-1, G).tolist()
    info = res[H + G * B : H + (G + I) * B].reshape(B, I).tolist()
    return status, head, geos, info, blob, entries


def _corpus(rng, geometry, n_files=5, truncate=True):
    level, rows, nb, ch = geometry
    srcs = [testing.random_acm_bytes(rng, level=level, rows=rows,
                                     n_blocks=nb, channels=ch, max_pwr=12)
            for _ in range(n_files)]
    if truncate:
        srcs.append(srcs[0][: len(srcs[0]) * 2 // 3])
    return srcs


def _starts(rng, rac, files, frames, ch):
    """Crops at block 0, at the last block, inside, reaching the clip's
    decodable end, and past it (a truncated file's end included)."""
    out = []
    for n, i in enumerate(files):
        idx = rac._entry(i)[1]
        total = rac.pcm_total(i)
        end = min(idx.header.total_values, idx.words_avail) // ch
        last = (idx.n_good - 1) * idx.header.block_len // ch
        out.append([0, max(0, last), int(rng.integers(0, max(1, total))),
                    max(0, end - frames // 2), end + 3][n % 5])
    return out


def _batch(geometry, seed):
    rng = np.random.default_rng(seed)
    if geometry == "mixed":
        shapes = [(7, 16, 8, 1), (4, 40, 6, 1), (3, 1, 9, 1), (0, 64, 5, 1),
                  (7, 16, 3, 1)]
        srcs = [testing.random_acm_bytes(rng, level=lv, rows=r, n_blocks=nb,
                                         max_pwr=12)
                for lv, r, nb, _ in shapes]
        srcs.append(srcs[0][: len(srcs[0]) * 2 // 3])
        ch, frames = 1, 3000
    else:
        srcs = _corpus(rng, geometry)
        level, rows, _, ch = geometry
        frames = max(1, (3 * (rows << level)) // (2 * ch))
    rac = RandomAccessCorpus(srcs, device="cpu", max_cached_files=8)
    files = rng.integers(0, len(srcs), 12).tolist()
    return rac, srcs, files, _starts(rng, rac, files, frames, ch), frames, ch


CASES = GEOMETRIES + ["mixed"]


@pytest.mark.parametrize("geometry", CASES)
@pytest.mark.parametrize("seed", [1, 2])
def test_native_plan_equals_the_python_plan(geometry, seed):
    rac, _, files, starts, frames, ch = _batch(geometry, seed)
    status, head, geos, info, _, entries = _native(rac, files, starts, frames)
    assert status == native.CROPS_DONE
    plans = [_plain_plan(e[1], s, frames, ch) for e, s in zip(entries, starts)]
    order = []  # geometries in order of first appearance
    for p in plans:
        if p["device"] and p["geo"] not in order:
            order.append(p["geo"])
    assert head[2] == len(order)
    assert head[3] == sum(not p["device"] for p in plans)
    assert head[6] == sum(p["device"] for p in plans)
    for j, (p, f) in enumerate(zip(plans, info)):
        assert f[3] == p["valid"], j
        if not p["device"]:
            assert f[:2] == [native.CROP_HOST, -1]
            continue
        g = order.index(p["geo"])
        assert f[:3] == [native.CROP_DEVICE, g, p["sw"]]
        assert (f[4], f[5], f[6], f[7]) == (p["nb"], p["nb"], p["lo"],
                                            p["warm"])
    for g, (geo, row) in enumerate(zip(order, geos)):
        ps = [p for p in plans if p["device"] and p["geo"] == geo]
        nbp = -(-max(p["need"] for p in ps) // 8) * 8
        assert row[:4] == [*geo, len(ps), nbp]
        assert row[12:] == [sum(p["warm"] for p in ps),
                            len(ps) * nbp - sum(p["nb"] for p in ps),
                            int(any(p["valid"] < frames * ch for p in ps)),
                            ps[0]["lo"]]


@pytest.mark.parametrize("geometry", CASES)
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("pad", [True, False])
def test_plan_only_call_equals_the_full_calls_plan(geometry, seed, pad):
    """A null blob asks for the plan alone: the same status and CROP_INFO
    rows as the full call, but the blocks a span decoded (only a scan
    knows them), and nothing else written."""
    rac, _, files, starts, frames, _ = _batch(geometry, seed)
    entries = [rac._entry(i) for i in files]
    B = len(files)
    status, res, _ = ra._scan_crops(entries, starts, frames, pad, CPU)
    full = ra._info(res, B).copy()
    size = H + (G + I) * B
    out = np.full(size + 64, -7, np.int64)
    plan_status = native.scan_crops(
        b"".join(e[3] for e in entries),
        np.asarray(starts, np.int64).tobytes(), B, frames, pad, 0, 0,
        out.ctypes.data)
    assert plan_status == status
    assert status == native.CROPS_DONE or (
        not pad and status == native.CROPS_PAD_REFUSED)
    plan = ra._info(out, B)
    np.testing.assert_array_equal(np.delete(plan, 5, axis=1),
                                  np.delete(full, 5, axis=1))
    assert not plan[:, 5].any()
    assert out[0] == status and not out[1 : H + G * B].any()
    assert (out[size:] == -7).all()


def _ingest_wire(ps, entries_of, level, rows, nbp):
    """The nine sections and lens the ingest path makes of these spans: the
    spans' bytes staged back to back, native.scan_corpus_chunk into zeroed
    wire buffers, the sections cut to the lengths a launch ships, and
    corpus._coalesce_wire."""
    w = tcorpus._WireBufs(len(ps), nbp, level, rows, CPU)
    for a in (w.pay4, w.pay8, w.pay16, w.wid4, w.wid8, w.wid16):
        a[:] = 0
    first, last = [], []
    for p, (data, idx) in zip(ps, entries_of):
        bit = (int(idx.bitpos[p["a0"]]) if p["a0"]
               else 8 * idx.header.data_start)
        end = p["a0"] + p["nb"]
        first.append(bit)
        last.append(len(data) if end >= idx.n_good else
                    min(len(data), -(-int(idx.bitpos[end]) // 8) + 16))
    first = np.asarray(first, np.int64)
    lo_bytes = first // 8
    lens = np.asarray(last, np.int64) - lo_bytes
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    staged = np.concatenate([np.frombuffer(d, np.uint8, n, lb)
                             for (d, _), lb, n in zip(
                                 entries_of, lo_bytes.tolist(),
                                 lens.tolist())])
    out, _, ncol, bits = native.scan_corpus_chunk(
        staged, offs, lens, first - 8 * lo_bytes,
        np.asarray([p["nb"] for p in ps], np.int64), level, rows, w.cls,
        w.pwr, w.vals, w.pay4, w.pay8, w.pay16, w.wid4, w.wid8, w.wid16,
        native.CorpusScanBuffers(max_file_bytes=int(lens.max())), nbp + 64)
    assert out[:, 0].tolist() == [p["nb"] for p in ps]

    def cut(arr, used):
        n = min(tcorpus._round_up(used + 2, 256), len(arr))
        return arr[: n - (n & 1)]

    secs = (w.cls, cut(w.pay4, -(-bits[0] // 8)),
            cut(w.pay8, -(-bits[1] // 8)), cut(w.pay16, -(-bits[2] // 8)),
            cut(w.wid4, -(-ncol[0] // 2)), cut(w.wid8, -(-ncol[1] // 2)),
            cut(w.wid16, -(-ncol[2] // 2)), w.vals, w.wrap0)
    return tcorpus._coalesce_wire(secs)


@pytest.mark.parametrize("geometry", CASES)
def test_blob_equals_the_ingest_scan_and_coalesce(geometry):
    rac, _, files, starts, frames, ch = _batch(geometry, 3)
    status, head, geos, info, blob, entries = _native(rac, files, starts,
                                                      frames)
    assert status == native.CROPS_DONE
    plans = [_plain_plan(e[1], s, frames, ch) for e, s in zip(entries, starts)]
    want = frames * ch
    meta = []
    for level, rows, count, nbp, off, size, *lens, _, _, _, _ in geos:
        js = [j for j, p in enumerate(plans)
              if p["device"] and p["geo"] == (level, rows)]
        assert len(js) == count
        wire, ingest_lens = _ingest_wire(
            [plans[j] for j in js], [entries[j][:2] for j in js], level,
            rows, nbp)
        assert tuple(lens) == ingest_lens
        assert cols_blob_layout(level, count, nbp, ingest_lens)[1] == size
        np.testing.assert_array_equal(blob[off : off + size], wire)
        assert off % 256 == 0
        meta += [plans[j]["lo"] for j in js] + [plans[j]["valid"] for j in js]
    host = [j for j, p in enumerate(plans) if not p["device"]]
    order = [j for g in geos for j, p in enumerate(plans)
             if p["device"] and p["geo"] == tuple(g[:2])] + host
    if order != list(range(len(files))):
        inverse = np.empty(len(files), np.int64)
        inverse[order] = np.arange(len(files))
        meta += inverse.tolist()
    assert head[7] == int(order != list(range(len(files))))
    last = geos[-1][4] + geos[-1][5] if geos else 0
    assert head[4] == -(-last // 256) * 256
    assert head[5] == -(-(head[4] + 2 * want * len(host)) // 8) * 8
    assert head[1] == head[5] + 8 * len(meta)
    assert blob[head[5] : head[1]].view(np.int64).tolist() == meta


def _device_and_host_errors(srcs, files, starts, frames, **kw):
    errors = []
    for rac in (RandomAccessCorpus(srcs, device="cpu"),
                RandomAccessCorpus(srcs, backend="host")):
        with pytest.raises(ValueError) as exc:
            rac.read_batch(files, starts, frames, **kw)
        errors.append(str(exc.value))
    return errors


def test_pad_false_and_mixed_channels_raise_as_the_python_plan():
    rng = np.random.default_rng(41)
    srcs = _corpus(rng, (4, 16, 6, 1))
    total = RandomAccessCorpus(srcs, device="cpu").pcm_total(1)
    files, starts = [0, 1, 2, 1], [0, total - 99, 5, total + 4]
    dev, host = _device_and_host_errors(srcs, files, starts, 100, pad=False)
    assert dev == host == ("crop 1 (file 1, frame %d): 99 of 100 frames "
                           "decodable and pad=False" % (total - 99))
    stereo = srcs + [testing.random_acm_bytes(rng, level=4, rows=16,
                                              n_blocks=4, channels=2)]
    dev, host = _device_and_host_errors(stereo, [0, len(srcs)], [0, 0], 64)
    assert dev == host == ("a batch needs files of one channel count, got "
                           "[1, 2]")


@pytest.mark.parametrize("cut", ["past the bytes", "inside the bytes"])
def test_stale_index_raises_as_the_python_plan(cut):
    rng = np.random.default_rng(42)
    data = testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=10)
    idx = build_index(data)
    bl = idx.header.block_len
    a0 = 5  # a crop from block 6: one warm-up block
    keep = (int(idx.bitpos[a0]) // 8 - 2 if cut == "past the bytes"
            else int(idx.bitpos[a0 + 2]) // 8)
    rac = RandomAccessCorpus([data], device="cpu")
    rac.pcm_total(0)  # the index of the whole file
    rac._data_lru[0] = data[:keep]  # the bytes changed since
    plan = _plain_plan(idx, 6 * bl + 1, 2 * bl, 1)
    if cut == "past the bytes":
        keep_bit = 8 * keep
        assert int(idx.bitpos[a0]) >= keep_bit
        n_good = 0
    else:
        cls, pwr, vals, *streams = ra._index_scratch(plan["nb"], 4, 8)
        n_good = native.scan_corpus_into(
            data[:keep], idx.header, cls, pwr, vals, *streams,
            native.scan_buffers(keep), start_bit=int(idx.bitpos[a0]),
            max_blocks=plan["nb"])[0]
        assert 0 < n_good < plan["nb"]
    with pytest.raises(ValueError) as exc:
        rac.read_batch([0], [6 * bl + 1], 2 * bl)
    assert str(exc.value) == str(ra._stale(plan["nb"], n_good))


def test_host_rows_of_a_stale_amp_table_file():
    stale = (FIXTURES / "stale_table_fuzz_2103.acm").read_bytes()
    assert build_index(stale).oor
    rng = np.random.default_rng(43)
    clean = testing.random_acm_bytes(rng, level=3, rows=58, n_blocks=4)
    srcs = [stale, clean]
    rac = RandomAccessCorpus(srcs, device="cpu")
    files, starts, frames = [0, 1, 0, 1, 0], [0, 100, 700, 5, 900], 300
    status, head, geos, info, blob, entries = _native(rac, files, starts,
                                                      frames)
    assert status == native.CROPS_DONE
    assert [f[0] for f in info] == (
        [native.CROP_HOST, native.CROP_DEVICE] * 2 + [native.CROP_HOST])
    assert head[2:4] == [1, 3] and head[6] == 2
    got = rac.read_batch(files, starts, frames)
    host = RandomAccessCorpus(srcs, backend="host").read_batch(files, starts,
                                                               frames)
    assert torch.equal(got, host)
    for j in (0, 2, 4):
        want = ra._host_words(stale, info[j][2], info[j][3], frames)
        np.testing.assert_array_equal(got[j].view(-1).numpy(), want)


def test_a_clip_dropped_from_the_lru_is_registered_again():
    rng = np.random.default_rng(44)
    srcs = [testing.random_acm_bytes(rng, level=5, rows=8, n_blocks=5)
            for _ in range(4)]
    rac = RandomAccessCorpus(srcs, device="cpu", max_cached_files=2)
    host = RandomAccessCorpus(srcs, backend="host")

    def check(files, starts):
        assert torch.equal(rac.read_batch(files, starts, 200),
                           host.read_batch(files, starts, 200))

    check([0, 1], [10, 20])
    reg0 = rac._clip_rows[0]
    assert set(rac._clip_rows) == {0, 1}
    check([2], [30])
    assert set(rac._clip_rows) == {1, 2}  # 0 dropped with its bytes
    check([0, 2], [40, 50])
    assert set(rac._clip_rows) == {0, 2}
    assert rac._clip_rows[0] is not reg0
    assert rac._clip_rows[0][0] is rac._data_lru[0]


def test_a_blob_too_small_at_first_is_grown():
    rac, srcs, files, starts, frames, _ = _batch((7, 16, 9, 1), 5)
    ra._TLS.crop_blob_bytes = 64
    try:
        got = rac.read_batch(files, starts, frames)
        assert ra._TLS.crop_blob_bytes > 64
    finally:
        del ra._TLS.crop_blob_bytes
    host = RandomAccessCorpus(srcs, backend="host")
    assert torch.equal(got, host.read_batch(files, starts, frames))


def _counters(rac, files, starts, frames):
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rac.read_batch(files, starts, frames)
    return profiling.totals()["counters"]


def test_native_crops_and_block_counters_under_a_profiler_only():
    rng = np.random.default_rng(45)
    srcs = _corpus(rng, (7, 16, 9, 1), truncate=False)
    srcs.append((FIXTURES / "stale_table_fuzz_2103.acm").read_bytes())
    rac = RandomAccessCorpus(srcs, device="cpu")
    files, starts, frames = [0, 1, 2, 3, 4], [0, 3000, 9000, 100, 4000], 2500
    profiling.reset()
    rac.read_batch(files, starts, frames)
    assert profiling.totals()["counters"] == {}
    c = _counters(rac, files, starts, frames)
    assert c["libacm.random_access.native_crops"] == 5
    assert c["libacm.random_access.crops"] == 5
    plans = [_plain_plan(rac._entry(i)[1], s, frames, 1)
             for i, s in zip(files, starts)]
    nbp = -(-max(p["need"] for p in plans) // 8) * 8
    assert c["libacm.random_access.blocks"] == 5 * nbp
    assert c["libacm.random_access.warmup_blocks"] == sum(
        p["warm"] for p in plans)
    assert c["libacm.random_access.pad_blocks"] == 5 * nbp - sum(
        p["nb"] for p in plans)
    # one crop of the stale-amp-table file goes to the host
    c = _counters(rac, files + [5], starts + [10], frames)
    assert c["libacm.random_access.crops"] == 6
    assert c["libacm.random_access.native_crops"] == 5


def test_threads_share_a_small_lru_and_its_crop_table():
    """Twelve threads read batches at once from one corpus whose file LRU
    holds two of six clips, so entries are dropped and registered again
    while other threads' native calls read them; every batch is the host
    decoder's."""
    import sys
    import threading

    rng = np.random.default_rng(46)
    srcs = [testing.random_acm_bytes(rng, level=4, rows=8, n_blocks=4)
            for _ in range(6)]
    rac = RandomAccessCorpus(srcs, device="cpu", max_cached_files=2)
    host = RandomAccessCorpus(srcs, backend="host")
    draws = [(rng.integers(0, 6, 3).tolist(), rng.integers(0, 300, 3).tolist())
             for _ in range(24)]
    want = [host.read_batch(f, s, 64) for f, s in draws]
    wrong, errors = [], []

    def work(t: int) -> None:
        try:
            for k in range(20):
                j = (k * 7 + t) % len(draws)
                if not torch.equal(rac.read_batch(*draws[j], 64), want[j]):
                    wrong.append(j)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:3]
    assert not wrong
    assert len(rac._clip_rows) <= 2


def test_package_data_ships_every_scanner_source():
    """An installed port builds the scanner from the sources native.py
    reads, so the package data lists each of them."""
    import tomllib

    root = pathlib.Path(__file__).resolve().parents[1]
    with open(root / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    shipped = data["libacm_tpu_torch.scan"]
    assert native._SRC.name in shipped and native._UNIT.name in shipped


def test_a_missing_source_builds_nothing(tmp_path, monkeypatch):
    """A scanner source absent from an install is a failed build (no
    native path), not an exception out of every native call."""
    monkeypatch.setenv("LIBACM_TPU_TORCH_CACHE", str(tmp_path))
    monkeypatch.setattr(native, "_UNIT", tmp_path / "absent.cpp")
    assert native._build() is None
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("channels", [1, 2])
def test_read_reuses_the_registered_crop_row(channels, monkeypatch):
    """RandomAccessCorpus.read hands its file's registered row of the
    native crop table to the device route; read_segment, which has no
    corpus, makes one of its own. Both read the same frames."""
    rng = np.random.default_rng(45)
    srcs = [testing.speech_acm_bytes(rng, level=5, rows=16, n_blocks=9,
                                     channels=channels) for _ in range(2)]
    rac = RandomAccessCorpus(srcs, device="cpu")
    rac.read_batch([0, 1], [0, 0], 64)
    rows = []
    real = native.clip_row
    monkeypatch.setattr(native, "clip_row",
                        lambda *a: rows.append(a) or real(*a))
    for start, n in ((0, 50), (300, 700), (10**6, 5), (-3, 40)):
        got = rac.read(1, start, n)
        assert got.dtype == np.int16 and got.shape[1] == channels
        idx = build_index(srcs[1])
        words = ra.read_segment(srcs[1], idx, start * channels,
                                n * channels, device="cpu")
        want = words[: len(words) - len(words) % channels]
        np.testing.assert_array_equal(got.reshape(-1), want)
    # read_segment's own rows, one a read (a read past the end is planned
    # too); read made none
    assert len(rows) == 4
