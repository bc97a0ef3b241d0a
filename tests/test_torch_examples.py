"""Smoke tests: every example of the port runs end to end on fixtures, as
tests/test_examples.py runs the JAX package's. They run as subprocesses
with `--device cpu`; without a device argument and without a card they
must fail, not carry on quietly on the CPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
EXAMPLES = REPO / "examples"


def _run(args, timeout=240, **env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("LIBACM_TPU_TORCH_DEVICE", None)
    env.update(env_extra)
    return subprocess.run([sys.executable, *map(str, args)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_examples_corpus")
    for name in ("speech_22k_mono.acm", "music_44k_stereo.acm",
                 "wavc_22k.acm"):
        shutil.copy(FIXTURES / name, d / name)
    # walk_acm discovers by content: one payload under a foreign suffix
    shutil.copy(FIXTURES / "speech_22k_mono.acm", d / "hidden.dat")
    return d


def test_torch_transcode_corpus_example(corpus_dir, tmp_path):
    out = tmp_path / "wav"
    r = _run([EXAMPLES / "torch_transcode_corpus.py", corpus_dir, out,
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    wavs = sorted(p.name for p in out.glob("*.wav"))
    assert wavs == ["hidden.wav", "music_44k_stereo.wav",
                    "speech_22k_mono.wav", "wavc_22k.wav"]
    for w in out.glob("*.wav"):
        assert w.read_bytes()[:4] == b"RIFF"
    assert "files ok" in r.stdout
    # byte-equal to what the JAX package's example writes
    jout = tmp_path / "jwav"
    j = subprocess.run(
        [sys.executable, str(EXAMPLES / "transcode_corpus.py"),
         str(corpus_dir), str(jout)], capture_output=True, text=True,
        timeout=240, env=dict(os.environ, LIBACM_TPU_PLATFORM="cpu",
                              PYTHONPATH=str(REPO)))
    assert j.returncode == 0, j.stderr
    for w in wavs:
        assert (out / w).read_bytes() == (jout / w).read_bytes(), w


def test_torch_stream_player_example(corpus_dir):
    r = _run([EXAMPLES / "torch_stream_player.py",
              corpus_dir / "speech_22k_mono.acm", "0.5", "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    assert "streamed" in r.stdout and "seek to 500 ms" in r.stdout
    assert "device stream:" in r.stdout and "on cpu" in r.stdout


@pytest.mark.parametrize("extra", [[], ["--devices", "3"]])
def test_torch_training_ingest_example(corpus_dir, extra):
    r = _run([EXAMPLES / "torch_training_ingest.py", corpus_dir,
              "--device", "cpu", *extra])
    assert r.returncode == 0, r.stderr
    assert "mean energy" in r.stdout and "summary:" in r.stdout


def test_torch_segment_server_self_demo():
    # the device named by the environment, as a deployment would set it
    r = _run([EXAMPLES / "torch_segment_server.py"],
             LIBACM_TPU_TORCH_DEVICE="cpu")
    assert r.returncode == 0, r.stderr
    assert "self-demo OK" in r.stdout


@pytest.mark.parametrize("example", ["torch_transcode_corpus.py",
                                     "torch_training_ingest.py",
                                     "torch_stream_player.py",
                                     "torch_segment_server.py"])
def test_torch_examples_default_to_the_card(corpus_dir, tmp_path, example):
    """No --device and no card: the example fails and names CUDA."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    args = {
        "torch_transcode_corpus.py": [corpus_dir, tmp_path / "wav"],
        "torch_training_ingest.py": [corpus_dir],
        "torch_stream_player.py": [corpus_dir / "speech_22k_mono.acm"],
        "torch_segment_server.py": [],  # the self-demo
    }[example]
    r = _run([EXAMPLES / example, *args])
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
