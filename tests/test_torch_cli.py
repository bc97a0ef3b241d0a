"""The port's acmtool (libacm_tpu_torch.cli) against the goldens.

Mirrors tests/test_cli.py and tests/test_cli_encode.py with the port's
CLI decoding on the CPU (LIBACM_TPU_TORCH_DEVICE=cpu): every golden
.raw / .wav / .info / .stderr byte-equal, the same flags and messages.
Without that setting and without a card, decode exits non-zero.
"""

import contextlib
import io
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from libacm_tpu_torch import cli, testing
from libacm_tpu_torch import io as tio
from libacm_tpu_torch.scan import oracle

ALL_FIXTURES = [
    "speech_22k_mono", "music_44k_stereo", "mistagged_mono", "wavc_22k",
    "level0", "level9", "rows1", "rows4095", "eofpad", "oddtotal_stereo",
    "partial_total", "allfillers", "corrupt", "trunc_midfiller",
    "trunc_colbound",
]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("LIBACM_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("LIBACM_TPU_TORCH_PROFILE", raising=False)


def run_cli(args):
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        code = 0
        try:
            code = cli.main(args)
        except SystemExit as e:
            code = e.code
    return code, so.getvalue(), se.getvalue()


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_raw_decode_matches_reference_golden(name, fixtures_dir, goldens_dir,
                                             tmp_path):
    src = fixtures_dir / f"{name}.acm"
    out = tmp_path / "out.raw"
    code, stdout, stderr = run_cli(["-d", "-r", "-o", str(out), str(src)])
    assert code == 0
    assert out.read_bytes() == (goldens_dir / f"{name}.raw").read_bytes()
    assert stderr.replace(str(src), "%SRC%") == \
        (goldens_dir / f"{name}.stderr").read_bytes().decode()
    assert stdout.replace(str(src), "%SRC%") == \
        (goldens_dir / f"{name}.info").read_bytes().decode()


@pytest.mark.parametrize("name", ["speech_22k_mono", "music_44k_stereo",
                                  "wavc_22k", "eofpad", "oddtotal_stereo"])
def test_wav_decode_matches_reference_golden(name, fixtures_dir, goldens_dir,
                                             tmp_path):
    src = fixtures_dir / f"{name}.acm"
    out = tmp_path / "out.wav"
    run_cli(["-d", "-q", "-o", str(out), str(src)])
    assert out.read_bytes() == (goldens_dir / f"{name}.wav").read_bytes()


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_info_matches_reference_golden(name, fixtures_dir, goldens_dir):
    src = fixtures_dir / f"{name}.acm"
    code, stdout, _ = run_cli(["-i", str(src)])
    assert code == 0
    assert stdout.replace(str(src), "%SRC%") == \
        (goldens_dir / f"{name}.info").read_bytes().decode()


def test_default_output_name(fixtures_dir, tmp_path):
    src = tmp_path / "thing.acm"
    shutil.copy(fixtures_dir / "rows1.acm", src)
    run_cli(["-d", "-q", str(src)])
    assert (tmp_path / "thing.wav").exists()
    run_cli(["-d", "-r", "-q", str(src)])
    assert (tmp_path / "thing.raw").exists()
    src2 = tmp_path / "noext"
    shutil.copy(fixtures_dir / "rows1.acm", src2)
    run_cli(["-d", "-q", str(src2)])
    assert (tmp_path / "noext.wav").exists()


def test_no_output_benchmark_mode(fixtures_dir, tmp_path):
    src = tmp_path / "x.acm"
    shutil.copy(fixtures_dir / "rows1.acm", src)
    code, stdout, _ = run_cli(["-d", "-n", str(src)])
    assert code == 0
    assert not (tmp_path / "x.wav").exists()
    assert "Length" in stdout


def test_retag_channels(fixtures_dir, tmp_path):
    from libacm_tpu_torch import acm_open_file

    src = tmp_path / "x.acm"
    shutil.copy(fixtures_dir / "speech_22k_mono.acm", src)
    run_cli(["-S", str(src)])
    acm = acm_open_file(src)
    assert acm.info.acm_channels == 2 and acm.channels == 2
    code, stdout, _ = run_cli(["-i", str(src)])
    assert "Chans:2(2)" in stdout
    run_cli(["-M", str(src)])
    assert acm_open_file(src).info.acm_channels == 1
    orig = oracle.decode_bytes(
        (fixtures_dir / "speech_22k_mono.acm").read_bytes())[1]
    np.testing.assert_array_equal(orig, oracle.decode_bytes(src.read_bytes())[1])


def test_retag_refuses_non_acm(tmp_path):
    bad = tmp_path / "bad.acm"
    bad.write_bytes(b"not acm at all....")
    _, _, stderr = run_cli(["-M", str(bad)])
    assert "not an ACM file" in stderr


def test_command_exclusivity_and_version():
    code, _, stderr = run_cli(["-d", "-i", "x"])
    assert code == 1
    assert "only one command at a time" in stderr
    code, stdout, _ = run_cli(["-v"])
    assert code == 0 and "acmtool" in stdout


def test_stdout_output(fixtures_dir):
    src = fixtures_dir / "rows1.acm"

    class _Cap(io.TextIOBase):
        def __init__(self):
            self.buffer = io.BytesIO()

        def write(self, s):
            return len(s)

    cap = _Cap()
    old = sys.stdout
    sys.stdout = cap
    try:
        cli.main(["-d", "-r", "-o", "-", str(src)])
    finally:
        sys.stdout = old
    raw = cap.buffer.getvalue()
    want = oracle.decode_bytes(src.read_bytes())[1]
    assert raw[: len(want) * 2] == want.astype("<i2").tobytes()


def test_windowed_decode_path_bytes_equal(tmp_path, monkeypatch):
    rng = np.random.default_rng(99)
    for hostile in (False, True):
        data = testing.speech_acm_bytes(rng, level=6, rows=16, n_blocks=30)
        if hostile:
            b = bytearray(data)
            b[200] ^= 0xFF
            data = bytes(b)
        src = tmp_path / f"in_{hostile}.acm"
        src.write_bytes(data)

        def run(out):
            _, _, err = run_cli(["-d", "-r", "-q", "-o", str(out), str(src)])
            return out.read_bytes(), err

        fast, err_fast = run(tmp_path / "fast.raw")
        with monkeypatch.context() as m:
            m.setattr(cli, "_WINDOWED_DECODE_BYTES", 0)
            win, err_win = run(tmp_path / "win.raw")
        assert win == fast
        assert ("filler_samples" in err_win) == ("filler_samples" in err_fast)


def test_play_streams_progressively(tmp_path, monkeypatch):
    import types

    rng = np.random.default_rng(55)
    data = testing.speech_acm_bytes(rng, level=5, rows=16, n_blocks=12)
    src = tmp_path / "p.acm"
    src.write_bytes(data)
    played = []

    class StubStream:
        def __init__(self, samplerate, channels, dtype):
            assert (samplerate, channels, dtype) == (22050, 1, "int16")

        def __enter__(self):
            return self

        def __exit__(self, *a):
            pass

        def write(self, buf):
            played.append(bytes(buf))

    monkeypatch.setitem(sys.modules, "sounddevice",
                        types.SimpleNamespace(RawOutputStream=StubStream))
    _, _, err = run_cli(["-p", "-q", str(src)])
    want = oracle.decode_bytes(data)[1].astype("<i2").tobytes()
    assert b"".join(played) == want
    assert max(len(c) for c in played) <= 4096
    assert "filler" not in err


def test_decode_without_card_exits_nonzero(fixtures_dir, tmp_path,
                                           monkeypatch):
    """No card and no LIBACM_TPU_TORCH_DEVICE: -d and -p exit 1 with a
    message naming the variable, write nothing and never fall back to the
    CPU; -i (no synthesis) still works."""
    monkeypatch.delenv("LIBACM_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = fixtures_dir / "speech_22k_mono.acm"
    out = tmp_path / "out.raw"
    for args in (["-d", "-r", "-o", str(out), str(src)], ["-p", str(src)]):
        code, _, stderr = run_cli(args)
        assert code == 1
        assert "LIBACM_TPU_TORCH_DEVICE" in stderr
    assert not out.exists()
    code, stdout, _ = run_cli(["-i", str(src)])
    assert code == 0 and "A:7/16" in stdout


def test_profile_env_writes_trace(fixtures_dir, tmp_path, monkeypatch):
    """LIBACM_TPU_TORCH_PROFILE=<dir> wraps the decode in a torch.profiler
    trace, exported as Chrome JSON into <dir>; the output is unchanged."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("LIBACM_TPU_TORCH_PROFILE", str(prof))
    src = fixtures_dir / "speech_22k_mono.acm"
    out = tmp_path / "out.raw"
    code, _, _ = run_cli(["-d", "-r", "-q", "-o", str(out), str(src)])
    assert code == 0
    assert out.read_bytes() == (fixtures_dir.parent / "goldens"
                                / "speech_22k_mono.raw").read_bytes()
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


# -- acmtool -e (tests/test_cli_encode.py) -----------------------------------


def _wav_bytes(pcm, channels, rate):
    return tio.wav_header(len(pcm) // channels, channels, rate) + \
        pcm.astype("<i2").tobytes()


def test_cli_encode_decode_roundtrip(tmp_path):
    t = np.arange(3 * 2048)
    pcm = (800 * np.sin(t / 25.0)).astype(np.int16)
    wav = tmp_path / "in.wav"
    wav.write_bytes(_wav_bytes(pcm, 1, 22050))
    out = tmp_path / "out.acm"
    assert run_cli(["-e", "-q", "-o", str(out), str(wav)])[0] == 0
    from libacm_tpu import cli as jcli

    jout = tmp_path / "jax.acm"
    with contextlib.redirect_stdout(io.StringIO()):
        jcli.main(["-e", "-q", "-o", str(jout), str(wav)])
    assert out.read_bytes() == jout.read_bytes()
    h, got, _ = oracle.decode_bytes(out.read_bytes())
    assert h.rate == 22050 and h.channels == 1 and got.shape == pcm.shape
    back = tmp_path / "back.wav"
    assert run_cli(["-d", "-q", "-o", str(back), str(out)])[0] == 0
    ch, rate, pcm2 = tio.read_wav(back.read_bytes())
    assert (ch, rate) == (1, 22050)
    np.testing.assert_array_equal(pcm2, got)


def test_cli_encode_rejects_non_wav_and_names_output(tmp_path):
    bad = tmp_path / "x.wav"
    bad.write_bytes(b"not a wav")
    code, _, stderr = run_cli(["-e", str(bad)])
    assert code == 0 and "not a RIFF/WAVE" in stderr
    wav = tmp_path / "thing.wav"
    wav.write_bytes(_wav_bytes(np.zeros(100, np.int16), 1, 22050))
    assert run_cli(["-e", "-q", str(wav)])[0] == 0
    assert (tmp_path / "thing.acm").exists()
