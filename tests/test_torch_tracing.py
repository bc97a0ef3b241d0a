"""The program's spans and counters (libacm_tpu_torch.utils.profiling) on
the corpus path, and the benchmark's readers of them.

On the CPU with device="cpu": nothing is recorded without a profiler and
a traced decode equals an untraced one; under profiling.trace(dir) every
span of the corpus path lands in the exported trace, the submitter
thread's and the scanner threads' too, on the clock of the in-memory
record, nested in its parent; the scan wait spans are
CorpusSummary.scan_s, the scan spans one a device group, the scanner
counters recorded; one host_decode span a stale-amp-table file; self
times are never negative; and each of the
benchmark's span metrics reads None from nothing and the right number
from a made-up record. The case marked `cuda` runs the same on a card and
holds the copy counters to the bytes handed to it.
"""

from __future__ import annotations

import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from libacm_tpu_torch import testing
from libacm_tpu_torch.parallel import corpus as tcorpus
from libacm_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
STALE = ROOT / "tests" / "fixtures" / "stale_table_fuzz_2103.acm"

#: every span of the corpus path: (name, its parent's name, thread)
SPANS = {
    "libacm.corpus.decode": (None, "caller"),
    "libacm.corpus.headers": ("libacm.corpus.decode", "caller"),
    "libacm.corpus.scan": ("libacm.corpus.decode", "scanner"),
    "libacm.corpus.scan.stage": ("libacm.corpus.scan", "scanner"),
    "libacm.corpus.scan.native": ("libacm.corpus.scan", "scanner"),
    "libacm.corpus.scan.host_decode": ("libacm.corpus.scan", "scanner"),
    "libacm.corpus.scan.wait": ("libacm.corpus.decode", "caller"),
    "libacm.corpus.wait": ("libacm.corpus.decode", "caller"),
    "libacm.corpus.dispatch": ("libacm.corpus.decode", "submitter"),
    "libacm.corpus.coalesce": ("libacm.corpus.dispatch", "submitter"),
    "libacm.corpus.copy": ("libacm.corpus.dispatch", "submitter"),
    "libacm.corpus.launch": ("libacm.corpus.dispatch", "submitter"),
    "libacm.corpus.checksum": (None, "caller"),
}


def _files(n_stale: int = 1) -> list[bytes]:
    rng = np.random.default_rng(17)
    files = [testing.random_acm_bytes(rng, level=7, rows=16, n_blocks=3,
                                      max_pwr=14) for _ in range(4)]
    files += [testing.random_acm_bytes(rng, level=3, rows=16, n_blocks=4,
                                       max_pwr=12) for _ in range(3)]
    files.append(files[0][: len(files[0]) // 2])
    files.append(b"not an ACM stream")
    stale = STALE.read_bytes()
    for k in range(n_stale):
        files.insert(2 + 3 * k, stale)
    return files


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _traced(tmp_path, files, **kw):
    """decode_corpus_device + checksum() under profiling.trace: (corpus,
    checksum, the exported trace, the in-memory records)."""
    with profiling.trace(tmp_path / "t"):
        dc = tcorpus.decode_corpus_device(files, **kw)
        cs = dc.checksum()
    (path,) = (tmp_path / "t").glob("*.json")
    return dc, cs, json.loads(path.read_text()), profiling.records()


def _span_events(trace: dict) -> list[dict]:
    """The host events of the program's spans in an exported trace (a span
    around device work may also show on the device's row, as
    gpu_user_annotation: left out)."""
    return [ev for ev in trace["traceEvents"]
            if ev.get("ph") == "X"
            and ev.get("cat") in ("cpu_op", "user_annotation")
            and ev.get("name", "").startswith("libacm.")]


def _same_decode(a, b) -> None:
    ra, rb = a.to_results(), b.to_results()
    assert [(r.index, r.status, r.filler_words) for r in ra] == [
        (r.index, r.status, r.filler_words) for r in rb]
    for x, y in zip(ra, rb):
        assert (x.pcm is None) == (y.pcm is None)
        if x.pcm is not None:
            np.testing.assert_array_equal(x.pcm, y.pcm)
    for (ia, pa), (ib, pb) in zip(a.device_arrays(), b.device_arrays()):
        assert ia == ib and torch.equal(pa, pb)
    assert a.checksum() == b.checksum()


KWARGS = [dict(device="cpu"), dict(device="cpu", chunk_files=1),
          dict(devices=["cpu"] * 3), dict(device="cpu", pack=False)]


@pytest.mark.parametrize("kw", KWARGS, ids=["auto", "chunk1", "three",
                                            "dense"])
def test_no_profiler_records_nothing(kw):
    dc = tcorpus.decode_corpus_device(_files(), **kw)
    dc.checksum()
    assert profiling.records() == []
    assert profiling.totals() == {"spans": {}, "counters": {}}
    assert profiling.call("libacm.x") is profiling.OFF
    assert profiling.span("libacm.x") is profiling.OFF
    profiling.count("libacm.x", 5)
    assert profiling.totals()["counters"] == {}


@pytest.mark.parametrize("kw", KWARGS, ids=["auto", "chunk1", "three",
                                            "dense"])
def test_traced_decode_equals_untraced(tmp_path, kw):
    files = _files()
    plain = tcorpus.decode_corpus_device(files, **kw)
    traced, cs, _, recs = _traced(tmp_path, files, **kw)
    assert recs
    assert cs == plain.checksum()
    _same_decode(plain, traced)


def test_every_span_lands_in_the_exported_trace(tmp_path):
    _, _, trace, recs = _traced(tmp_path, _files(), device="cpu",
                                chunk_files=2)
    tids: dict[str, set] = {}
    for ev in _span_events(trace):
        tids.setdefault(ev["name"], set()).add(ev["tid"])
    assert set(tids) == set(SPANS)
    caller = tids["libacm.corpus.decode"]
    submitter = tids["libacm.corpus.dispatch"]
    scanners = tids["libacm.corpus.scan"]
    assert not caller & submitter and not scanners & (caller | submitter)
    for name, (_, thread) in SPANS.items():
        if thread == "caller":
            assert tids[name] == caller, name
        elif thread == "submitter":
            assert tids[name] == submitter, name
        else:
            assert tids[name] and tids[name] <= scanners, name
    # the in-memory record names the same threads
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, set()).add(r.thread)
    assert by_name == tids


def test_each_span_nests_in_its_parent(tmp_path):
    dc, _, trace, recs = _traced(tmp_path, _files(2), devices=["cpu"] * 2,
                                 chunk_files=1)
    by_id = {r.id: r for r in recs}
    roots = {r.call: r for r in recs if r.parent is None}
    assert {r.name for r in roots.values()} == {"libacm.corpus.decode",
                                               "libacm.corpus.checksum"}
    for r in recs:
        assert r.start_ns <= r.end_ns
        assert r.call in roots
        want_parent, _ = SPANS[r.name]
        if want_parent is None:
            assert r.parent is None and r.call == r.id
            continue
        p = by_id[r.parent]
        assert p.name == want_parent and p.call == r.call
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, r.name
    # every span of the decode shares its id, the submitter's too
    decode = next(r for r in roots.values()
                  if r.name == "libacm.corpus.decode")
    assert {r.call for r in recs if r.name != "libacm.corpus.checksum"} == {
        decode.id}
    assert sum(r.name == "libacm.corpus.dispatch" for r in recs) == len(
        {r.attrs["chunk"] for r in recs
         if r.name == "libacm.corpus.dispatch"})
    # and in the exported trace, on each thread, inside an event of the
    # parent's name
    events = _span_events(trace)
    for ev in events:
        want_parent, _ = SPANS[ev["name"]]
        if want_parent is None:
            continue
        assert any(p["name"] == want_parent
                   and p["ts"] <= ev["ts"]
                   and ev["ts"] + ev["dur"] <= p["ts"] + p["dur"]
                   for p in events), ev["name"]


def test_trace_and_record_share_one_clock(tmp_path):
    """Each span's record holds its trace event (the record's stamps are
    taken outside the record_function's), and its start lies within 1 ms
    of the event's but for a thread's first span, whose event the
    profiler may stamp late while it sets the thread up; every end lies
    within 1 ms."""
    _, _, trace, recs = _traced(tmp_path, _files(), device="cpu",
                                chunk_files=2)
    base = int(trace["baseTimeNanoseconds"])
    events: dict[tuple, list] = {}
    for ev in _span_events(trace):
        events.setdefault((ev["name"], ev["tid"]), []).append(
            (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    spans: dict[tuple, list] = {}
    for r in recs:
        spans.setdefault((r.name, r.thread), []).append(
            ((r.start_ns - base) / 1e3, (r.end_ns - base) / 1e3))
    assert set(spans) == set(events)
    first = {tid: min(r.start_ns for r in recs if r.thread == tid)
             for tid in {r.thread for r in recs}}
    firsts = {(r.start_ns - base) / 1e3 for r in recs
              if r.start_ns == first[r.thread]}
    for key in events:
        got, want = sorted(events[key]), sorted(spans[key])
        assert len(got) == len(want), key
        for (ts, te), (rs, re) in zip(got, want):
            assert rs - 50 <= ts and te <= re + 50, (key, ts, te, rs, re)
            assert re - te < 1000.0, (key, te, re)
            if rs not in firsts:
                assert ts - rs < 1000.0, (key, ts, rs)


def _two_scans_at_once(monkeypatch):
    """Hold the first two scans of a call until both run, so the scanner
    threads scan at once (each file here scans in microseconds)."""
    meet = threading.Barrier(2, timeout=60)
    real = tcorpus._scan_cols_wire
    n = []

    def scan(*args):
        n.append(1)
        if len(n) <= 2:
            meet.wait()
        return real(*args)

    monkeypatch.setattr(tcorpus, "_scan_cols_wire", scan)


@pytest.mark.parametrize("kw", KWARGS[:3], ids=["auto", "chunk1", "three"])
def test_scan_spans_are_the_summarys_scan_s(tmp_path, kw, monkeypatch):
    monkeypatch.setattr(tcorpus, "_scan_workers", lambda: 4)
    _two_scans_at_once(monkeypatch)
    dc, _, _, recs = _traced(tmp_path, _files(), **kw)
    waits = [r for r in recs if r.name == "libacm.corpus.scan.wait"]
    assert waits and dc.summary.scan_s > 0
    # the caller's time blocked on the scans is scan_s
    assert sum(r.seconds for r in waits) == pytest.approx(
        dc.summary.scan_s, rel=1e-12)
    t = profiling.totals()
    spans = t["spans"]
    assert spans["libacm.corpus.scan.wait"]["total_s"] == pytest.approx(
        dc.summary.scan_s, rel=1e-12)
    # one wait a chunk, one dispatch a chunk
    assert len(waits) == spans["libacm.corpus.dispatch"]["count"]
    # stage + native + host decodes + the scan's own time = the scans,
    # summed over the scanner threads
    scans = [r for r in recs if r.name == "libacm.corpus.scan"]
    parts = sum(spans[n]["total_s"] for n in spans
                if n.startswith("libacm.corpus.scan.")
                and n != "libacm.corpus.scan.wait")
    assert parts + spans["libacm.corpus.scan"]["self_s"] == pytest.approx(
        sum(r.seconds for r in scans), rel=1e-9)
    # one scan span a device group of a chunk
    groups = sum(1 for ix, _ in dc.device_arrays() if ix)
    assert len(scans) == groups >= 2
    # the scanner counters: the pool's size, and scans that ran at once
    assert t["counters"]["libacm.corpus.scan.workers"] == 4
    assert t["counters"]["libacm.corpus.scan.overlapped"] > 0


@pytest.mark.parametrize("n_stale", [1, 2, 3])
def test_one_host_decode_span_a_stale_table_file(tmp_path, n_stale):
    dc, _, _, recs = _traced(tmp_path, _files(n_stale), device="cpu",
                             chunk_files=2)
    fell_back = sum(e.host_pcm is not None
                    for b in dc._buckets for e in b.entries)
    assert fell_back == n_stale
    spans = [r for r in recs if r.name == "libacm.corpus.scan.host_decode"]
    assert sum(r.attrs["fallback"] for r in spans) == fell_back
    assert len(spans) == fell_back  # none of these files overflows


def test_self_time_is_never_negative(tmp_path):
    _traced(tmp_path, _files(2), devices=["cpu"] * 2, chunk_files=1)
    for name, t in profiling.totals()["spans"].items():
        assert t["count"] > 0
        assert 0 <= t["self_s"] <= t["total_s"] + 1e-12, name


def test_spans_of_threads_that_run_at_once():
    """Two threads in one call: each span's parent is on its own stack,
    the root is shared by id, the children's time leaves only the
    parent's own thread."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        with profiling.call("libacm.test.root") as root:
            def worker():
                with profiling.span("libacm.test.worker", root):
                    with profiling.span("libacm.test.inner"):
                        profiling.count("libacm.test.n", 3)
            th = threading.Thread(target=worker)
            th.start()
            with profiling.span("libacm.test.main"):
                th.join()
    recs = {r.name: r for r in profiling.records()}
    assert recs["libacm.test.worker"].parent == root.id
    assert recs["libacm.test.inner"].parent == recs["libacm.test.worker"].id
    assert recs["libacm.test.main"].thread == recs["libacm.test.root"].thread
    assert recs["libacm.test.worker"].thread != recs["libacm.test.root"].thread
    assert {r.call for r in recs.values()} == {root.id}
    t = profiling.totals()
    assert t["counters"] == {"libacm.test.n": 3}
    main = recs["libacm.test.main"]
    assert t["spans"]["libacm.test.root"]["self_s"] == pytest.approx(
        (root.ns - (main.end_ns - main.start_ns)) / 1e9)
    profiling.reset()
    assert profiling.records() == [] and profiling.totals()["counters"] == {}


def test_spans_and_counts_of_many_threads_lose_nothing():
    """More threads than cores, switching often, each opening spans under
    one root and counting: every span is recorded once, with an id of its
    own, and no count is lost."""
    import sys

    n_threads, n_each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.call("libacm.test.root") as root:
                def worker():
                    for _ in range(n_each):
                        with profiling.span("libacm.test.w", root):
                            profiling.count("libacm.test.n", 1)
                threads = [threading.Thread(target=worker)
                           for _ in range(n_threads)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=60)
                assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    recs = profiling.records()
    assert len(recs) == n_threads * n_each + 1
    assert len({r.id for r in recs}) == len(recs)
    t = profiling.totals()
    assert t["spans"]["libacm.test.w"]["count"] == n_threads * n_each
    assert t["counters"] == {"libacm.test.n": n_threads * n_each}


# -- the benchmark's readers -------------------------------------------------

#: metric -> its reading of the made-up record below
METRICS = {
    "corpus.headers_ms_per_pass.ingest": 4.0,
    "scan.stage_ms_per_pass.ingest": 20.0,
    "scan.native_ms_per_pass.ingest": 600.0,
    "scan.host_decode_ms_per_pass.ingest": 15.0,
    "corpus.wait_ms_per_pass.ingest": 1.5,
    "submit.busy_pct.ingest": 5.0,
    "copy.host_ms_per_pass.ingest": 30.0,
    "copy.pageable_MB_per_pass.ingest": 165.0,
}


class _Run:
    def __init__(self, passes):
        self.record = {"passes": passes}


def _reader(name):
    from acmbench.harness import bench

    return bench.metric_reader(ROOT, name)


def _made_up(monkeypatch) -> _Run:
    """Two passes of 0.8 s: spans at twice a pass's reading (one a pass),
    the dispatch spans 5 % of 1.6 s, 330 MB copied from pageable memory."""
    recs, ids = [], iter(range(1, 1000))

    def rec(name, ms, parent=None, call=1, thread=1):
        i = next(ids)
        recs.append(profiling.SpanRecord(name, i, parent, call, thread, 0,
                                         int(ms * 1e6), {}))
        return i

    for p in range(2):
        root = rec("libacm.corpus.decode", 790.0)
        rec("libacm.corpus.headers", 4.0, root)
        scan = rec("libacm.corpus.scan", 700.0, root)
        rec("libacm.corpus.scan.stage", 20.0, scan)
        rec("libacm.corpus.scan.native", 600.0, scan)
        rec("libacm.corpus.scan.host_decode", 15.0, scan)
        rec("libacm.corpus.wait", 1.5, root)
        d = rec("libacm.corpus.dispatch", 40.0, root, thread=2)
        rec("libacm.corpus.copy", 30.0, d, thread=2)
    monkeypatch.setattr(profiling, "_RECORD", recs)
    monkeypatch.setattr(profiling, "_COUNTERS",
                        {"libacm.copy.h2d_bytes.pageable": 330_000_000})
    return _Run([{"wall_s": 0.8, "scan_s": 0.7, "checksum": 0}] * 2)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_reads_none_from_nothing(name, monkeypatch):
    read = _reader(name)
    run = _Run([{"wall_s": 0.8, "scan_s": 0.7, "checksum": 0}])
    assert read(run) is None  # no profiler ran: nothing recorded
    # a program without the facility (the parent of this change)
    monkeypatch.delattr(profiling, "totals")
    assert read(run) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_reads_a_made_up_record(name, monkeypatch):
    run = _made_up(monkeypatch)
    assert _reader(name)(run) == pytest.approx(METRICS[name])
    assert _reader(name)(_Run([])) is None  # no pass


def test_readers_are_listed_for_both_ingest_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        m = listed[name]
        assert m["moves"] == "decode_Msamples_per_s"
        assert m["workloads"] == ["fallout-1000.ingest",
                                  "fallout-sharded-4.ingest"]
        assert m["source"] in ("program_span", "program_counter")
        assert (ROOT / "acmbench" / "metrics" / f"{name}.py").is_file()


def test_a_traced_cpu_run_of_the_ingest_cell_reads_every_metric(
        tmp_path):
    """The benchmark's own --trace 1 path, rehearsed on the CPU in a tiny
    checkout: every span metric finds something to read."""
    from acmbench.tests import tiny

    out = tiny.rehearse(tiny.checkout(tmp_path), "fallout-1000.ingest",
                        trace=1)
    assert out["correct"]
    assert set(METRICS) <= set(out["read"])


# -- on a card ---------------------------------------------------------------


@pytest.mark.cuda
def test_card_copy_counters_and_one_timeline(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    files = _files(2)
    plain = tcorpus.decode_corpus_device(files, device="cuda", chunk_files=2)
    handed: list[int] = []
    real = tcorpus._coalesce_wire

    def counting(arrays, wirebufs=None):
        blob, lens = real(arrays, wirebufs)
        handed.append(blob.nbytes)
        return blob, lens

    monkeypatch.setattr(tcorpus, "_coalesce_wire", counting)
    dc, cs, trace, recs = _traced(tmp_path, files, device="cuda",
                                  chunk_files=2)
    assert cs == plain.checksum()
    _same_decode(plain, dc)
    counters = {k: v for k, v in profiling.totals()["counters"].items()
                if k.startswith("libacm.copy.")}
    assert handed and sum(counters.values()) == sum(handed)
    assert counters == {"libacm.copy.h2d_bytes.pageable": sum(handed)}
    # both threads' spans, the kernels and the copies on one timeline:
    # every copy to the card and every kernel lies between the decode's
    # start and the checksum's end (which waits for the card)
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = _span_events(trace)
    assert {e["name"] for e in spans} == set(SPANS)
    assert len({e["tid"] for e in spans}) >= 3  # caller, submitter, scanners
    (root,) = [e for e in spans if e["name"] == "libacm.corpus.decode"]
    (last,) = [e for e in spans if e["name"] == "libacm.corpus.checksum"]
    lo, hi = root["ts"] - 1000.0, last["ts"] + last["dur"] + 1000.0
    device = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy")
              and "sleep" not in e.get("name", "")]
    assert any(e["cat"] == "kernel" for e in device)
    assert any("HtoD" in e["name"] for e in device)
    for e in device:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e["name"]
