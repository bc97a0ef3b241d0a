"""The benchmark's own yardstick on the CPU: the block-pool file maker, the
work counts of the roofline, the trace reduction with its spin guard, and
the open-loop scheduler."""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import pytest
import torch

from acmbench.gen import pool as gen
from acmbench.harness import bench, roofline, schedule, trace
from acmbench.loops import ingest
from acmbench.reference import oracle
from acmbench.tests import tiny

PINNED = {
    ("fallout-1000", 1): "a8fa34f29c040cbf",
    ("fallout-1000", 2**32 + 99): "b9944ae3b2d44854",
    ("bg-music", 1): "11983687aecbe3c6",
    ("bg-music", 2**32 + 99): "75dd9fbbb927f11d",
}


def _config(name: str) -> dict:
    return tiny.shrink(json.loads(
        (tiny.REPO / f"acmbench/configs/{name}.json").read_text()))


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_generator_bytes_are_pinned_per_seed(name, seed):
    c = gen.make_corpus(_config(name), seed)
    digest = hashlib.sha256(b"".join(f.data for f in c.files)).hexdigest()
    assert digest[:16] == PINNED[name, seed]


def test_seeds_change_content_and_order_not_the_work():
    a = gen.make_corpus(_config("bg-music"), 5)
    b = gen.make_corpus(_config("bg-music"), 6)
    assert [f.data for f in a.files] != [f.data for f in b.files]
    assert sorted(len(f.ids) for f in a.files) == sorted(
        len(f.ids) for f in b.files)
    for c in (a, b):
        for f in c.files:
            shares = np.bincount(f.ids, minlength=c.pools[0].n_blocks)
            assert shares.max() - shares.min() <= 1
    pa = gen.pool_blocks(np.random.default_rng(1), a.classes[0], 20)
    pb = gen.pool_blocks(np.random.default_rng(2), a.classes[0], 20)
    assert sorted(x.pwr for x in pa) == sorted(x.pwr for x in pb)
    assert sorted(x.val for x in pa) == sorted(x.val for x in pb)


def test_composed_files_decode_as_their_pool_blocks():
    c = gen.make_corpus(_config("fallout-1000"), 11)
    for f in c.files:
        if f.kind != "clean":
            continue
        pool = oracle.scan_bytes(c.pools[f.cls].data)
        whole = oracle.scan_bytes(f.data)
        assert np.array_equal(whole.k, pool.k[f.ids])
        assert np.array_equal(whole.val, pool.val[f.ids])
        assert not np.any(whole.events)


def test_every_file_is_distinct():
    c = gen.make_corpus(_config("fallout-1000"), 3)
    assert len({f.data for f in c.files}) == len(c.files)


def test_roofline_counts_the_inputs_whatever_the_chunking(tmp_path):
    """The least time of a pass comes from each file's payload and good
    blocks: the same for any chunk_files, and the program's checksum
    agrees across chunkings."""
    root = tiny.checkout(tmp_path)
    works, sums = [], []
    for chunk in (1, 3):
        spec = tiny.spec(root, "fallout-1000.ingest")
        spec.traffic = dict(spec.traffic, chunk_files=chunk)
        run = bench.run_cell(spec, tiny.SEED, 0.2, False,
                             [torch.device("cpu")], time.perf_counter())
        assert bench.correct(run)
        works.append(run.record["work"])
        sums.append({p["checksum"] for p in run.record["passes"]})
    assert works[0] == works[1] and sums[0] == sums[1]
    w = works[0]
    c = gen.make_corpus(spec.config, tiny.SEED)
    clean = [f for f in c.files if f.kind == "clean"]
    assert w["payload_bytes"] == sum(len(f.data) for f in c.files)
    assert w["samples"] >= sum(len(f.ids) * c.classes[f.cls].block_len
                               for f in clean)
    least = roofline.least_time_s(w["payload_bytes"], w["samples"],
                                  w["synth_ops"])
    assert least == max((w["payload_bytes"] + 2 * w["samples"])
                        / roofline.HBM_BYTES_PER_S,
                        w["synth_ops"] / roofline.INT32_OPS_PER_S)


def test_synth_ops_is_the_frozen_count():
    assert roofline.synth_ops(7, 2048) == 2048 * 16 + 2048 * 2 // 128
    assert roofline.synth_ops(0, 100) == 200


def _event(cat, name, ts, dur, device=0, nbytes=None):
    args = {"device": device}
    if nbytes is not None:
        args["bytes"] = nbytes
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace(with_spins: bool) -> dict:
    ev = [_event("user_annotation", "acmbench.window", 100.0, 1000.0),
          _event("user_annotation", "acmbench.read", 150.0, 300.0),
          _event("user_annotation", "acmbench.checksum", 600.0, 100.0),
          _event("kernel", "synth", 200.0, 100.0),
          _event("kernel", "unpack", 250.0, 100.0),
          _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 500.0,
                 50.0, nbytes=1000),
          _event("kernel", "before the window", 0.0, 50.0)]
    if with_spins:
        ev.append(_event("kernel", "at::cuda::spin_kernel(long)", 10.0, 1.0))
    return {"traceEvents": ev}


def test_trace_without_its_spin_kernels_is_not_trusted():
    s = trace.reduce(_trace(False), 1)
    assert not s.complete
    assert trace.idle_pct(s) is None


def test_trace_reduction_unions_device_time_and_names_idle_gaps():
    s = trace.reduce(_trace(True), 1)
    assert s.complete and s.window_us == 1000.0
    assert [e.name for e in s.events] == [
        "synth", "unpack", "Memcpy HtoD (Pageable -> Device)"]
    assert s.busy_s(0) == pytest.approx(200e-6)  # 200-350 and 500-550 us
    assert trace.idle_pct(s) == pytest.approx(80.0)
    gaps = dict(s.idle_gaps())
    # 100-200 and 350-500 us lie in the read span, 550-1100 in none
    assert gaps == pytest.approx({"acmbench.read": 250e-6,
                                  "outside any span": 550e-6})


def test_open_loop_times_requests_from_when_they_were_due():
    """One worker, a request due every 10 ms, each served in 30 ms: the
    queue grows, and request i waits for the i before it."""
    due = np.arange(6) * 0.010

    def serve(i):
        time.sleep(0.030)

    res = schedule.run_open_loop(due, serve, workers=1)
    want = 0.030 * (np.arange(6) + 1) - due
    assert np.all(res.latency_s >= want - 0.002)
    assert np.all(res.latency_s <= want + 0.05)
    assert res.late_s[-1] >= 0.030 * 5 - due[-1] - 0.002
    assert res.failed == 0


def test_open_loop_counts_failed_requests():
    def serve(i):
        if i % 2:
            raise ValueError("no")

    res = schedule.run_open_loop(np.zeros(6), serve, workers=3)
    assert res.failed == 3


def test_poisson_arrivals_are_seeded_and_inside_the_window():
    a = schedule.poisson_arrivals(np.random.default_rng(4), 500.0, 2.0)
    b = schedule.poisson_arrivals(np.random.default_rng(4), 500.0, 2.0)
    assert np.array_equal(a, b)
    assert a.max() < 2.0 and np.all(np.diff(a) > 0)
    assert 850 < len(a) < 1150


def test_ingest_work_counts_every_good_block():
    c = gen.make_corpus(_config("fallout-1000"), 2)
    from acmbench.harness import expect

    exps = expect.expected(c, "cpu")
    w = ingest.work(c, exps)
    assert w["samples"] == sum(e.n_good * e.block_len for e in exps)
