"""The port's ingest adapters and profiling hooks ≡ the JAX package's.

Mirrors the ingest cases of tests/test_aux.py and tests/test_examples.py
(walk_acm discovering by content) with the port decoding on the CPU
(device="cpu"); outputs equal the JAX package's, tolerance 0.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from libacm_tpu import ingest as jingest
from libacm_tpu import testing
from libacm_tpu_torch import ingest
from libacm_tpu_torch.parallel import decode_corpus


def _stream_bytes(seed=0, n_blocks=6):
    rng = np.random.default_rng(seed)
    return testing.random_acm_bytes(rng, level=3, rows=16, n_blocks=n_blocks)


def test_iter_pcm_matches_batch_and_jax():
    files = [_stream_bytes(seed=i, n_blocks=2 + i % 3) for i in range(7)]
    whole = decode_corpus(files, device="cpu")
    streamed = list(ingest.iter_pcm(files, batch_files=3, device="cpu"))
    want = list(jingest.iter_pcm(files, batch_files=3))
    assert len(streamed) == len(whole) == len(want)
    for x, y, w in zip(streamed, whole, want):
        assert x.index == y.index == w.index
        np.testing.assert_array_equal(x.pcm, y.pcm)
        np.testing.assert_array_equal(x.pcm, w.pcm)


def test_iter_frames_like_jax():
    files = [_stream_bytes(seed=1, n_blocks=2), _stream_bytes(seed=2)]
    frames = list(ingest.iter_frames(files, 1000, batch_files=1,
                                     device="cpu"))
    want = list(jingest.iter_frames(files, 1000, batch_files=1))
    assert len(frames) == len(want)
    for (i, f), (wi, wf) in zip(frames, want):
        assert i == wi and f.shape == (1000,) and f.dtype == np.int16
        np.testing.assert_array_equal(f, wf)
    total = 2 * 16 * 8
    assert frames[0][1][total % 1000:].tolist() == [0] * (1000 - total % 1000)


def test_decode_to_wav_dir_like_cli_and_jax(tmp_path, monkeypatch):
    src = tmp_path / "a.acm"
    src.write_bytes(_stream_bytes(seed=3))
    cut = tmp_path / "b.acm"
    cut.write_bytes(_stream_bytes(seed=4)[:300])
    res = ingest.decode_to_wav_dir([src, cut], tmp_path / "out",
                                   device="cpu")
    jres = jingest.decode_to_wav_dir([src, cut], tmp_path / "jout")
    assert [r.status for r in res] == [r.status for r in jres]
    assert res[0].ok
    for name in ("a.wav", "b.wav"):
        assert (tmp_path / "out" / name).read_bytes() == \
            (tmp_path / "jout" / name).read_bytes()
    from libacm_tpu_torch import cli

    monkeypatch.setenv("LIBACM_TPU_TORCH_DEVICE", "cpu")
    cli.main(["-d", "-q", "-o", str(tmp_path / "cli.wav"), str(src)])
    assert (tmp_path / "out" / "a.wav").read_bytes() == \
        (tmp_path / "cli.wav").read_bytes()


def test_torch_frame_dataset_like_jax(tmp_path):
    from torch.utils.data import DataLoader

    rng = np.random.default_rng(21)
    files = []
    for i in range(5):
        f = tmp_path / f"f{i}.acm"
        f.write_bytes(testing.speech_acm_bytes(rng, level=3, rows=8,
                                               n_blocks=2 + i % 3))
        files.append(str(f))
    want = list(jingest.iter_frames(files, 512))
    got = [(int(i), fr.numpy())
           for i, fr in ingest.torch_frame_dataset(files, 512, device="cpu")]
    assert len(got) == len(want)
    for (wi, wf), (gi, gf) in zip(want, got):
        assert wi == gi
        np.testing.assert_array_equal(wf, gf)
    loader = DataLoader(ingest.torch_frame_dataset(files, 512, device="cpu"),
                        batch_size=4)
    assert sum(len(b[0]) for b in loader) == len(want)


def test_run_corpus_job_checkpoint_resume(tmp_path):
    rng = np.random.default_rng(404)
    files = []
    for i in range(7):
        data = testing.speech_acm_bytes(rng, level=3, rows=8, n_blocks=3)
        if i == 4:
            data = data[: len(data) - 6]
        p = tmp_path / f"f{i}.acm"
        p.write_bytes(data)
        files.append(str(p))
    files.insert(2, str(tmp_path / "missing.acm"))
    cp = tmp_path / "job.json"
    seen = []

    class Crash(RuntimeError):
        pass

    def crashing(r):
        if len(seen) == 5:
            raise Crash()
        seen.append(r.index)

    with pytest.raises(Crash):
        ingest.run_corpus_job(files, cp, batch_files=3, on_result=crashing,
                              device="cpu")
    assert json.loads(cp.read_text())["cursor"] == 3
    summary = ingest.run_corpus_job(files, cp, batch_files=3, device="cpu",
                                    on_result=lambda r: seen.append(r.index))
    assert summary["resumed_at"] == 3 and summary["cursor"] == len(files)
    assert sorted(set(seen)) == list(range(len(files)))
    want = jingest.run_corpus_job(files, tmp_path / "jax.json",
                                  batch_files=3)
    for key in ("files", "n_ok", "n_failed", "n_partial", "samples"):
        assert summary[key] == want[key], key
    again = ingest.run_corpus_job(files, cp, batch_files=3, device="cpu",
                                  on_result=lambda r: seen.append(-1))
    assert again["resumed_at"] == len(files) and -1 not in seen


def test_walk_acm_by_content_like_jax(tmp_path, fixtures_dir):
    for name in ("speech_22k_mono.acm", "music_44k_stereo.acm",
                 "wavc_22k.acm"):
        shutil.copy(fixtures_dir / name, tmp_path / name)
    shutil.copy(fixtures_dir / "speech_22k_mono.acm", tmp_path / "hidden.dat")
    (tmp_path / "notes.txt").write_text("not audio")
    got = ingest.walk_acm(tmp_path)
    assert got == jingest.walk_acm(tmp_path)
    assert sorted(p.name for p in got) == [
        "hidden.dat", "music_44k_stereo.acm", "speech_22k_mono.acm",
        "wavc_22k.acm"]


def test_ingest_default_needs_card(monkeypatch):
    monkeypatch.delenv("LIBACM_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        list(ingest.iter_pcm([_stream_bytes()]))


def test_profiling_trace_and_annotate(tmp_path, monkeypatch):
    """The program's spans (profiling.call / span, which replaced
    annotate): nothing without a profiler, the trace's events and the
    in-memory record under trace(dir) and LIBACM_TPU_TORCH_PROFILE."""
    from libacm_tpu_torch.utils import profiling

    profiling.reset()
    monkeypatch.delenv("LIBACM_TPU_TORCH_PROFILE", raising=False)
    with profiling.maybe_trace_from_env():  # unset: no trace, no file
        with profiling.call("libacm.scan") as sp:
            assert sp is profiling.OFF
    assert profiling.records() == []
    with profiling.trace(tmp_path / "t"):
        with profiling.call("libacm.scan"):
            with profiling.span("libacm.scan.stage", files=8):
                torch.ones(8).sum()
    monkeypatch.setenv("LIBACM_TPU_TORCH_PROFILE", str(tmp_path / "env"))
    with profiling.maybe_trace_from_env():
        with profiling.call("libacm.env"):
            pass
    for d, want in (("t", {"libacm.scan", "libacm.scan.stage"}),
                    ("env", {"libacm.env"})):
        (path,) = (tmp_path / d).glob("*.json")
        names = {e.get("name") for e in json.loads(path.read_text())[
            "traceEvents"]}
        assert want <= names
    recs = profiling.records()
    assert [r.name for r in recs] == ["libacm.scan.stage", "libacm.scan",
                                      "libacm.env"]
    assert recs[0].parent == recs[1].id and recs[0].attrs == {"files": 8}
    profiling.reset()
