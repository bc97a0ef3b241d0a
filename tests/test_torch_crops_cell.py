"""The benchmark's `ljspeech-acm.crops` cell (acmbench/loops/crops.py and
its metric readers), rehearsed on the CPU.

The tiny checkout of acmbench/tests/tiny.py cuts the clips to 3-24 blocks
of 2,048 frames, shorter than a crop of 8,192, so these tests give the
checkout's copy of the mix their own crop length and batch. A traced run
is correct and every program metric reads a number; a sound run is
correct, and a batch served twice, crops left empty, an answer altered
where it is produced, or a failing call each make it not correct; the
float32 control is not correct at the configuration's own clip lengths;
each reader returns None where nothing was recorded and the right number
from a made-up record; and the sampler, the work count and the cell's
entries in BENCHMARK.json are what the mix says.
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import pytest
import torch

from libacm_tpu_torch.parallel import random_access
from libacm_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "ljspeech-acm.crops"
#: the tiny checkout's crops: 2,048 frames, 4 clips a batch
TINY_MIX = {"batch": 4, "segment_frames": 2048, "warm_batches": 2,
            "keep_batches": 4}

PROGRAM_METRICS = ["random_access.index_ms_per_batch.crops",
                   "random_access.scan_ms_per_batch.crops",
                   "random_access.launch_ms_per_batch.crops",
                   "random_access.copy_ms_per_batch.crops",
                   "random_access.overhead_blocks_pct.crops"]
DEVICE_METRICS = ["kernels.roofline_pct.crops", "device.idle_pct.crops"]


def _mix(root: pathlib.Path, **params) -> pathlib.Path:
    path = root / "acmbench" / "traffic" / "crops.json"
    mix = json.loads(path.read_text())
    mix.update(params)
    path.write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    from acmbench.tests import tiny

    return _mix(tiny.checkout(tmp_path_factory.mktemp("tiny")), **TINY_MIX)


def _run(root, seconds: float = 0.3):
    from acmbench.harness import bench
    from acmbench.tests import tiny

    return bench.run_cell(tiny.spec(root, CELL), tiny.SEED, seconds, False,
                          [torch.device("cpu")], time.perf_counter())


def test_traced_rehearsal_reads_every_program_metric(tiny_root):
    from acmbench.tests import tiny

    out = tiny.rehearse(tiny_root, CELL, trace=1)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"crops_wrong", "batch_folds_wrong",
                                  "crops_failed"}
    assert set(PROGRAM_METRICS) <= set(out["read"])
    assert not {"jax", "libacm_tpu"} & set(out["modules"])


def test_sound_run_is_correct(tiny_root):
    from acmbench.harness import bench

    run = _run(tiny_root)
    assert bench.correct(run), run.checks
    assert run.record["batches"] >= 1
    assert run.e2e["decode_Msamples_per_s"] > 0
    assert run.attempted == run.record["batches"] * TINY_MIX["batch"]


def _stale_batch(monkeypatch):
    orig = random_access.RandomAccessCorpus.read_batch
    first = []

    def read_batch(self, *a, **kw):
        out = orig(self, *a, **kw)
        return first[0] if first else first.append(out) or out

    monkeypatch.setattr(random_access.RandomAccessCorpus, "read_batch",
                        read_batch)


def _half_the_crops(monkeypatch):
    orig = random_access.RandomAccessCorpus.read_batch

    def read_batch(self, files, starts, frames, **kw):
        out = orig(self, files, starts, frames, **kw)
        out[len(files) // 2 :] = 0
        return out

    monkeypatch.setattr(random_access.RandomAccessCorpus, "read_batch",
                        read_batch)


def _altered_sample(monkeypatch):
    from libacm_tpu_torch.ops import synth_torch

    orig = synth_torch.synth_pcm_cols_blob

    def synth(*a, **kw):
        pcm, carry = orig(*a, **kw)
        pcm.view(-1)[7::2048] ^= 1  # a sample of every block
        return pcm, carry

    monkeypatch.setattr(synth_torch, "synth_pcm_cols_blob", synth)


def _a_call_fails(monkeypatch):
    orig = random_access.RandomAccessCorpus.read_batch
    calls = [0]

    def read_batch(self, *a, **kw):
        calls[0] += 1
        if calls[0] == TINY_MIX["warm_batches"] + 1:  # the window's first
            raise RuntimeError("planted failure")
        return orig(self, *a, **kw)

    monkeypatch.setattr(random_access.RandomAccessCorpus, "read_batch",
                        read_batch)


FAULTS = {"state unchanged": _stale_batch, "half the batch": _half_the_crops,
          "answer altered": _altered_sample, "a call fails": _a_call_fails}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_root, fault, monkeypatch):
    from acmbench.harness import bench

    FAULTS[fault](monkeypatch)
    assert not bench.correct(_run(tiny_root))


@pytest.mark.parametrize("seed", [3, 2**32 + 8])
def test_float32_control_is_not_correct(tmp_path, seed):
    """At the configuration's own clip lengths and pool (16 clips), the
    reference in float32 gives wrong crops and wrong folds."""
    from acmbench import control_crops
    from acmbench.tests import tiny

    root = _mix(tiny.checkout(tmp_path), batch=4, keep_batches=4)
    conf = root / "acmbench" / "configs" / "ljspeech-acm.json"
    c = json.loads((ROOT / "acmbench" / "configs" / "ljspeech-acm.json")
                   .read_text())
    c["files"] = c["classes"][0]["files"] = 16
    conf.write_text(json.dumps(c))
    checks = control_crops.control_checks(tiny.spec(root, CELL), seed, "cpu",
                                          8)
    assert checks["crops_wrong"][0] > 0 and checks["batch_folds_wrong"][0] > 0


# -- the sampler and the work count -------------------------------------------


def test_sampler_is_hifigans():
    from acmbench.loops import crops

    frames = np.asarray([30000, 9000, 8192, 5000, 20000, 40000, 8200])
    draw = crops.batches(np.random.default_rng(1), frames, 3, 8192)
    for epoch in range(3):
        seen = []
        for _ in range(len(frames) // 3):  # drop_last: 2 batches an epoch
            files, starts = next(draw)
            assert len(set(files.tolist())) == 3
            seen += files.tolist()
            assert (starts >= 0).all()
            assert (starts <= np.maximum(frames[files] - 8192, 0)).all()
        assert len(set(seen)) == 6
    with pytest.raises(ValueError):
        next(crops.batches(np.random.default_rng(1), frames[:2], 3, 8192))
    assert crops.batch_size({"batch": 16}, 6) == 6  # a cut-down copy
    assert crops.batch_size({"batch": 16}, 13100) == 16


def test_work_counts_each_crops_own_blocks():
    from acmbench.gen.pool import make_corpus
    from acmbench.loops import crops

    c = json.loads((ROOT / "acmbench" / "configs" / "ljspeech-acm.json")
                   .read_text())
    c["classes"][0].update(files=3, blocks=[12, 14])
    c["pool_blocks"] = 8
    corpus = make_corpus(c, 5)
    ends = np.asarray([len(f.ids) * 2048 for f in corpus.files])
    files, starts = np.asarray([0, 1, 2]), np.asarray([0, 2047, 4096 + 1])
    w = crops.work(corpus, ends, [(files, starts)], 8192, 1)
    nbits = [corpus.pools[0].nbits[f.ids] for f in corpus.files]
    # blocks [0, 4), [0, 5) and [2, 7) of their clips
    want = (nbits[0][:4].sum() + nbits[1][:5].sum() + nbits[2][2:7].sum())
    assert w["payload_bytes"] == want // 8
    assert w["samples"] == 3 * 8192
    assert w["synth_ops"] == 3 * 8192 * 16 + 3 * 8192 * 2 // 128


# -- the metric readers ------------------------------------------------------


class _Run:
    def __init__(self, batches, summary=None, work=None):
        self.record = {"batches": batches}
        if work is not None:
            self.record["work"] = work

        class _T:
            pass

        self.tracer = _T()
        self.tracer.summary = summary


def _reader(name):
    from acmbench.harness import bench

    return bench.metric_reader(ROOT, name)


def _made_up(monkeypatch) -> _Run:
    """Four batches: index 0.2 ms, scan 1.2 ms, copy 0.1 ms, launch 0.4 ms
    a batch; 64 blocks synthesized, 8 warm-up and 24 pad; one kernel of
    1 ms and one of the fold's of 0.5 ms in a 10 ms window; work whose
    least time is 0.02 ms."""
    from acmbench.harness import roofline, trace

    recs, ids = [], iter(range(1, 1000))

    def rec(name, ms, parent=None):
        recs.append(profiling.SpanRecord(name, next(ids), parent, 1, 1, 0,
                                         int(ms * 1e6), {}))

    for _ in range(4):
        rec("libacm.random_access.batch", 2.0)
        rec("libacm.random_access.index", 0.2, 1)
        rec("libacm.random_access.scan", 1.2, 1)
        rec("libacm.random_access.copy", 0.1, 1)
        rec("libacm.random_access.launch", 0.4, 1)
    monkeypatch.setattr(profiling, "_RECORD", recs)
    monkeypatch.setattr(profiling, "_COUNTERS", {
        "libacm.random_access.blocks": 64,
        "libacm.random_access.warmup_blocks": 8,
        "libacm.random_access.pad_blocks": 24})
    summary = trace.TraceSummary(
        True, 0.0, 10_000.0,
        [trace.DeviceEvent("k", "kernel", 0, 100.0, 1000.0, None),
         trace.DeviceEvent("HtoD", "gpu_memcpy", 0, 2000.0, 500.0, 4096),
         trace.DeviceEvent("void at::native::reduce_kernel<512, 1>",
                           "kernel", 0, 3000.0, 500.0, None)],
        [], [0])
    payload = int(roofline.HBM_BYTES_PER_S * 2e-5) - 2 * 1000
    return _Run(4, summary, {"payload_bytes": payload, "samples": 1000,
                             "synth_ops": 1})


READINGS = {
    "random_access.index_ms_per_batch.crops": 0.2,
    "random_access.scan_ms_per_batch.crops": 1.2,
    "random_access.launch_ms_per_batch.crops": 0.4,
    "random_access.copy_ms_per_batch.crops": 0.1,
    "random_access.overhead_blocks_pct.crops": 50.0,
    "kernels.roofline_pct.crops": 2.0,
    "device.idle_pct.crops": 80.0,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_none_from_nothing(name, monkeypatch):
    profiling.reset()
    read = _reader(name)
    assert read(_Run(4)) is None  # no profiler ran: nothing recorded
    monkeypatch.delattr(profiling, "totals")  # a program without it
    assert read(_Run(4)) is None


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_a_made_up_record(name, monkeypatch):
    run = _made_up(monkeypatch)
    assert _reader(name)(run) == pytest.approx(READINGS[name])
    if name not in DEVICE_METRICS or name.startswith("kernels"):
        run.record["batches"] = 0
        assert _reader(name)(run) is None  # no batch


def test_cell_entries_in_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["config"] == "ljspeech-acm" and cell["traffic"] == "crops"
    assert cell["chips"] == 1
    (conf,) = [c for c in bench["configs"] if c["name"] == "ljspeech-acm"]
    assert conf["reduced"] == []
    (rate,) = [m for m in bench["end_to_end"]
               if m["name"] == "decode_Msamples_per_s"]
    assert rate["workloads"][-1] == CELL
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in READINGS:
        m = listed[name]
        assert m["moves"] == "decode_Msamples_per_s"
        assert m["workloads"] == [CELL]
        assert (ROOT / "acmbench" / "metrics" / f"{name}.py").is_file()
    mix = json.loads((ROOT / "acmbench" / "traffic" / "crops.json")
                     .read_text())
    assert (mix["batch"], mix["segment_frames"]) == (16, 8192)
    c = json.loads((ROOT / conf["file"]).read_text())
    (speech,) = c["classes"]
    assert (c["files"], speech["files"], speech["blocks"]) == (
        13100, 13100, [12, 109])
    assert (speech["level"], speech["rows"], speech["rate"]) == (7, 16, 22050)
