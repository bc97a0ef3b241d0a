"""The port's streaming API (libacm_tpu_torch.stream) ≡ the JAX package.

Every stream runs under both of the port's CPU routes: device="cpu"
(the kernel wrapper's plain torch version, the route a card takes) and
synth_backend="host" (the native host synth). The JAX package's
AcmStream and the checked-in goldens are the reference; the tolerance is
0 everywhere (bytes, error codes, positions).
"""

import io
import pathlib

import numpy as np
import pytest
import torch

from libacm_tpu import stream as jstream
from libacm_tpu import testing
from libacm_tpu.format import AcmException as JAcmException
from libacm_tpu_torch import (
    AcmError,
    AcmException,
    AcmStream,
    DecodeState,
    acm_open_decoder,
    acm_open_file,
    acm_read,
    acm_seek_pcm,
)
from libacm_tpu_torch import io as tio
from libacm_tpu_torch.format import cli_total_bytes
from libacm_tpu_torch.ops import synth_torch
from libacm_tpu_torch.scan import native, oracle

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
ALL_FIXTURES = sorted(p.stem for p in FIXTURES.glob("*.acm"))

#: the port's two CPU routes: open-call keyword arguments
MODES = {"cpu": {"device": "cpu"}, "host": {"synth_backend": "host"}}


def _open(data, mode, force_chans=0, **kw):
    return AcmStream(tio.BytesSource(data), force_chans, **MODES[mode], **kw)


def _drain(s, chunk=1 << 16, past_errors=False):
    """Read to EOF; stop at the first raised error, or keep reading past
    error events (each raised read consumes one)."""
    out = bytearray()
    while True:
        try:
            b = s.read_loop(chunk)
        except (AcmException, JAcmException):
            if past_errors:
                continue
            break
        if not b:
            break
        out += b
    return bytes(out)


def _cli_bytes(s):
    """What `acmtool -d -r` writes for a stream: 8 KiB read_loop calls
    until an error surfaces or EOF, then zero filler to the declared
    length (acmtool.c:269-310)."""
    total = cli_total_bytes(s.total_values, s.channels)
    out = bytearray()
    while len(out) < total:
        try:
            b = s.read_loop(8192)
        except AcmException:
            break
        if not b:
            break
        out += b
    return bytes(out) + bytes(max(0, total - len(out)))


def _mk(rng=None, **kw):
    rng = rng or np.random.default_rng(17)
    kw.setdefault("level", 4)
    kw.setdefault("rows", 64)
    kw.setdefault("n_blocks", 5)
    return testing.random_acm_bytes(rng, **kw)


def _full_pcm(data):
    _, pcm, _ = oracle.decode_bytes(data)
    return pcm


@pytest.fixture(params=sorted(MODES))
def mode(request):
    return request.param


# -- fixtures against JAX and the goldens ------------------------------------


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_fixture_decodes_like_jax_and_golden(name, mode):
    path = FIXTURES / f"{name}.acm"
    data = path.read_bytes()
    got = (acm_open_file(path, device="cpu") if mode == "cpu"
           else _open(data, mode))
    want = jstream.acm_open_decoder(data)
    assert (got.channels, got.rate, got.pcm_total()) == (
        want.channels, want.rate, want.pcm_total())
    assert _drain(got, past_errors=True) == _drain(want, past_errors=True)
    assert got.raw_tell() == want.raw_tell()
    golden = GOLDENS / f"{name}.raw"
    if golden.exists():
        assert _cli_bytes(_open(data, mode)) == golden.read_bytes()


# -- the cases of tests/test_stream.py, on both routes ----------------------


def test_read_returns_at_most_block_remainder(mode):
    acm = _open(_mk(), mode)
    block_bytes = acm.info.acm_rows * acm.info.acm_cols * 2
    assert len(acm.read(10 * block_bytes)) == block_bytes
    assert len(acm.read(100)) == 100
    assert len(acm.read(10 * block_bytes)) == block_bytes - 100


def test_read_loop_matches_oracle_and_jax(mode):
    data = _mk()
    acm = _open(data, mode)
    out = acm.read_loop(10**9)
    assert out == _full_pcm(data).astype("<i2").tobytes()
    assert out == jstream.acm_open_decoder(data).read_loop(10**9)
    assert acm.read_loop(4096) == b""


def test_output_formats(mode):
    data = _mk(n_blocks=2)
    for kw in ({"bigendianp": 1}, {"sgned": 0}, {"bigendianp": 1, "sgned": 0}):
        assert _open(data, mode).read_loop(10**9, **kw) == \
            jstream.acm_open_decoder(data).read_loop(10**9, **kw)


def test_badfmt_wordlen(mode):
    acm = _open(_mk(n_blocks=1), mode)
    assert acm_read(acm, 128, wordlen=1) == int(AcmError.ERR_BADFMT)
    with pytest.raises(AcmException) as ei:
        acm.read(128, wordlen=4)
    assert ei.value.code == int(AcmError.ERR_BADFMT)


def test_total_values_clamp_and_channel_multiple(mode):
    data = _mk(np.random.default_rng(23), channels=2,
               total_values=4 * 64 * 16 - 7)
    acm = _open(data, mode)
    assert len(acm.read_loop(10**9)) // 2 == 4 * 64 * 16 - 8
    assert acm.read(4096) == b""


def test_force_chans_quirk_modes(mode):
    mono = _mk(n_blocks=1, channels=1)
    wavc = _mk(np.random.default_rng(5), n_blocks=1, channels=1, wavc=True)
    stereo = _mk(np.random.default_rng(6), n_blocks=1, channels=2)
    for data in (mono, wavc, stereo):
        for fc in (0, -1, 1, 2):
            got = _open(data, mode, fc)
            want = jstream.acm_open_decoder(data, fc)
            assert (got.channels, got.info.acm_channels) == (
                want.channels, want.info.acm_channels)
            assert got.read_loop(10**9) == want.read_loop(10**9)


def test_seek_equivalence_with_straight_read(mode):
    data = _mk()
    full = _full_pcm(data).astype("<i2").tobytes()
    acm = _open(data, mode)
    assert acm.seek_pcm(1234) == 1234
    assert acm.read_loop(10**9) == full[1234 * 2:]
    assert acm.seek_pcm(0) == 0
    assert acm.read_loop(10**9) == full
    assert acm.seek_pcm(10**9) == len(full) // 2


def test_seek_time_like_jax(mode):
    data = _mk()
    acm, ref = _open(data, mode), jstream.acm_open_decoder(data)
    ms = acm.time_total() // 2
    assert acm.seek_time(ms) == ref.seek_time(ms)
    assert acm.read_loop(4096) == ref.read_loop(4096)


class _NoSeekSource:
    def __init__(self, data):
        self._b = tio.BytesSource(data)

    def read(self, size=-1):
        return self._b.read(size)


def test_not_seekable_semantics(mode):
    acm = AcmStream(_NoSeekSource(_mk(n_blocks=2)), **MODES[mode])
    assert not acm.seekable()
    assert acm.bitrate() == 13000
    acm.read(100)
    acm.read(100)
    assert acm_seek_pcm(acm, 500) == 500
    assert acm_seek_pcm(acm, 0) == int(AcmError.ERR_NOT_SEEKABLE)


def test_tell_accessors(mode):
    data = _mk(channels=2)
    acm = _open(data, mode)
    assert acm.pcm_total() == acm.total_values // 2
    acm.read(1000)
    assert acm.pcm_tell() == 250
    assert acm.time_tell() == 250 * 1000 // acm.rate
    assert acm.raw_total() == len(data)
    assert acm.bitrate() == 8 * len(data) * 1000 // acm.time_total()


def test_raw_tell_progression_like_jax(mode):
    data = _mk()
    acm, ref = _open(data, mode), jstream.acm_open_decoder(data)
    assert acm.raw_tell() == ref.raw_tell()
    while True:
        a, b = acm.read(4096), ref.read(4096)
        assert a == b and acm.raw_tell() == ref.raw_tell()
        if not a:
            break


def test_corrupt_stream_read_behavior(mode):
    acm = _open((FIXTURES / "corrupt.acm").read_bytes(), mode)
    hdr_block = acm.info.acm_rows * acm.info.acm_cols * 2
    assert len(acm.read_loop(hdr_block)) == hdr_block
    with pytest.raises(AcmException) as ei:
        acm.read(4096)
    assert ei.value.code == int(AcmError.ERR_CORRUPT)
    assert acm_read(acm, 4096) == b""
    acm.seek_pcm(0)
    assert len(acm.read(hdr_block)) == hdr_block


def test_read_loop_partial_before_error(mode):
    acm = _open((FIXTURES / "corrupt.acm").read_bytes(), mode)
    out = acm.read_loop(10**9)
    assert len(out) == acm.info.acm_rows * acm.info.acm_cols * 2


def test_expected_eof_mid_block_is_clean(mode):
    acm = _open((FIXTURES / "trunc_colbound.acm").read_bytes(), mode)
    assert len(acm.read_loop(10**9)) > 0


def test_unexpected_eof_is_error(mode):
    acm = _open((FIXTURES / "trunc_midfiller.acm").read_bytes(), mode)
    with pytest.raises(AcmException) as ei:
        while acm.read(10**6):
            pass
    assert ei.value.code == int(AcmError.ERR_UNEXPECTED_EOF)


def test_not_acm_open(mode):
    with pytest.raises(AcmException) as ei:
        _open(b"garbage data not acm", mode)
    assert ei.value.code == int(AcmError.ERR_NOT_ACM)


def test_zero_byte_read_returns_empty(mode):
    acm = _open(_mk(n_blocks=1), mode)
    assert acm.read(1) == b""
    assert acm.read(4096)


def test_acm_read_simulate_mode(mode):
    data = _mk()
    real, sim = _open(data, mode), _open(data, mode)
    for n in (100, 256, 74):
        got_sim = acm_read(sim, n, simulate=True)
        assert isinstance(got_sim, int)
        assert got_sim == len(acm_read(real, n))
    assert sim.pcm_tell() == real.pcm_tell()
    assert _drain(sim, 4096) == _drain(real, 4096)
    assert acm_read(sim, 512, simulate=True) == 0


# -- stale-amp-table seeks (the sequences of tests/test_ref_live.py) --------


def _stale_open(pkg, data, kind, mode):
    """A stream of package pkg ("jax" or "torch"): whole-file ("full") or
    windowed ("winN")."""
    if pkg == "jax":
        if kind == "full":
            return jstream.acm_open_decoder(data)
        return jstream.AcmStream(io.BytesIO(data), window_blocks=int(kind[3]))
    if kind == "full":
        return _open(data, mode)
    return AcmStream(io.BytesIO(data), window_blocks=int(kind[3]),
                     **MODES[mode])


def _seek_then_drain(s, pre, tgt):
    if pre is None:  # drain to terminal EOF, past error events
        _drain(s, past_errors=True)
    else:
        left = pre
        while left > 0:
            try:
                b = s.read_loop(min(1 << 16, left))
            except (AcmException, JAcmException):
                break
            if not b:
                break
            left -= len(b)
    s.seek_pcm(tgt)
    return _drain(s)


@pytest.mark.parametrize("kind", ["full", "win1", "win2", "win3", "win4"])
def test_seek_readahead_stale_like_jax(kind, mode):
    data = (FIXTURES / "seek_readahead_stale.acm").read_bytes()
    for pre, tgt in ((64, 0), (64, 1), (128, 0)):
        want = _seek_then_drain(_stale_open("jax", data, kind, mode), pre, tgt)
        got = _seek_then_drain(_stale_open("torch", data, kind, mode), pre,
                               tgt)
        assert got == want, (pre, tgt)


@pytest.mark.parametrize("kind", ["full", "win1", "win3"])
def test_seek_terminal_att_stale_like_jax(kind, mode):
    data = (FIXTURES / "seek_terminal_att_stale.acm").read_bytes()
    for tgt in (0, 1, 7):
        want = _seek_then_drain(_stale_open("jax", data, kind, mode), None,
                                tgt)
        got = _seek_then_drain(_stale_open("torch", data, kind, mode), None,
                               tgt)
        assert got == want, tgt


# -- windowed mode -----------------------------------------------------------


def _read_or_code(s, n):
    try:
        return s.read_loop(n)
    except (AcmException, JAcmException) as e:
        return e.code


@pytest.mark.parametrize("wb", [1, 2, 3, 4])
def test_windowed_like_jax(wb):
    """Windowed mode stays a native host decoder: bytes, raw_tell and
    seeks equal the JAX package's windowed stream and the port's
    whole-file stream, including hostile streams."""
    rng = np.random.default_rng(100 + wb)
    for i in range(4):
        data = testing.speech_acm_bytes(rng, level=5, rows=8, n_blocks=9,
                                        channels=1 + i % 2)
        if i >= 2:
            b = bytearray(data)
            b[40 + 17 * i] ^= 0x5A
            data = bytes(b)
        got = AcmStream(io.BytesIO(data), window_blocks=wb)
        want = jstream.AcmStream(io.BytesIO(data), window_blocks=wb)
        full = _open(data, "cpu")
        while True:
            res = [_read_or_code(s, 3000) for s in (got, want, full)]
            assert res[0] == res[1] == res[2]
            assert got.raw_tell() == want.raw_tell() == full.raw_tell()
            if res[0] == b"":
                break
        assert got.seek_pcm(100) == want.seek_pcm(100)
        assert _drain(got, 4096) == _drain(want, 4096)


# -- DecodeState across the packages -----------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("window", [None, 2])
def test_decode_state_crosses_packages(direction, window):
    data = testing.random_acm_bytes(np.random.default_rng(0), level=3,
                                    rows=16, n_blocks=6)

    def jopen():
        return jstream.AcmStream(io.BytesIO(data), window_blocks=window)

    def topen():
        return AcmStream(io.BytesIO(data), window_blocks=window,
                         device="cpu")

    src, dst = (jopen, topen) if direction == "jax_to_torch" else (topen,
                                                                    jopen)
    a = src()
    a.read_loop(1000)
    a.read(77)
    blob = a.get_state().to_json()
    rest = a.read_loop(10**6)
    b = dst()
    cls = DecodeState if direction == "jax_to_torch" else jstream.DecodeState
    b.set_state(cls.from_json(blob))
    assert b.read_loop(10**6) == rest
    assert b.pcm_tell() == a.pcm_tell()


def test_decode_state_channel_mismatch_rejected():
    data = testing.random_acm_bytes(np.random.default_rng(0), level=3,
                                    rows=16, n_blocks=6)
    st = jstream.acm_open_decoder(data).get_state()
    b = acm_open_decoder(data, force_chans=2, device="cpu")
    with pytest.raises(AcmException):
        b.set_state(DecodeState.from_json(st.to_json()))


# -- device resolution and decode_scan_result ---------------------------------


@pytest.mark.parametrize("how", ["decoder", "file", "class"])
def test_stream_default_needs_card(how, monkeypatch, tmp_path):
    """device=None is the card, resolved at the open: without one the open
    raises and names LIBACM_TPU_TORCH_DEVICE (the source is closed), and
    no read ever raises for want of a device; the CPU is taken only when
    asked for (device, LIBACM_TPU_TORCH_DEVICE or synth_backend="host")."""
    data = _mk(n_blocks=2)
    want = _full_pcm(data).astype("<i2").tobytes()
    path = tmp_path / "f.acm"
    path.write_bytes(data)
    monkeypatch.delenv("LIBACM_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class Src(io.BytesIO):
        closed_by_open = False

        def close(self):
            Src.closed_by_open = True
            super().close()

    opener = {"decoder": lambda: acm_open_decoder(data),
              "file": lambda: acm_open_file(path),
              "class": lambda: AcmStream(Src(data))}[how]
    with pytest.raises(RuntimeError, match="LIBACM_TPU_TORCH_DEVICE"):
        opener()
    if how == "class":
        assert Src.closed_by_open
    assert _open(data, "host").read_loop(10**9) == want
    assert acm_open_decoder(data, device="cpu").read_loop(10**9) == want
    monkeypatch.setenv("LIBACM_TPU_TORCH_DEVICE", "cpu")
    assert opener().read_loop(10**9) == want


@pytest.mark.parametrize("kind", ["windowed", "host"])
def test_stream_without_device_opens_and_reads(kind, monkeypatch):
    """Windowed mode and synth_backend="host" are host decoders: they
    open and read without a card and without LIBACM_TPU_TORCH_DEVICE, and
    the reference API's reads hand back bytes, never an exception."""
    from libacm_tpu_torch import acm_read

    data = _mk(n_blocks=3)
    want = _full_pcm(data).astype("<i2").tobytes()
    monkeypatch.delenv("LIBACM_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = (acm_open_decoder(data, window_blocks=2) if kind == "windowed"
         else AcmStream(io.BytesIO(data), synth_backend="host"))
    got = bytearray()
    while True:
        b = acm_read(s, 4096)
        assert isinstance(b, bytes)
        if not b:
            break
        got += b
    assert bytes(got) == want


@pytest.mark.parametrize("backend", ["auto", "jax", "pallas", "torch"])
def test_decode_scan_result_rejects_other_backends(backend):
    scan = native.scan_bytes(_mk(n_blocks=1))
    with pytest.raises(ValueError, match="backend"):
        synth_torch.decode_scan_result(scan, backend=backend, device="cpu")


@pytest.mark.parametrize("name", ["level0", "rows1", "rows4095",
                                  "stale_table_fuzz_2103", "speech_22k_mono"])
def test_decode_scan_result_like_jax(name):
    """Level 0 (a zero-width carry), rows == 1, a tall block, a
    stale-amp-table stream (the oracle route) and a plain one: the port's
    words equal the JAX package's on every route."""
    from libacm_tpu.ops import synth_jax
    from libacm_tpu.scan import scan_bytes as jscan_bytes

    data = (FIXTURES / f"{name}.acm").read_bytes()
    scan = native.scan_bytes(data) if native.available() else \
        oracle.scan_bytes(data)
    want = synth_jax.decode_scan_result(jscan_bytes(data), backend="jax")
    if name == "level0":
        assert scan.header.wrapbuf_len == 0
    for kw in ({"device": "cpu"}, {"backend": "host"}):
        np.testing.assert_array_equal(
            synth_torch.decode_scan_result(scan, **kw), want)
