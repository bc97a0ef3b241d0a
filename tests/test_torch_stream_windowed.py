"""The port's bounded-memory windowed stream: the cases of
tests/test_stream_windowed.py on libacm_tpu_torch.stream, each ALSO held
to the JAX package's windowed stream at tolerance 0.

Windowed mode is a native host decoder in both packages (no device): the
port's copy must give the same bytes, raw_tell, seeks, errors and
DecodeState as the JAX package's, and the same bytes as its own whole-file
stream (synthesis on device="cpu").
"""

import io
import warnings

import numpy as np
import pytest

from libacm_tpu import stream as jstream
from libacm_tpu import testing
from libacm_tpu.format import AcmException as JAcmException
from libacm_tpu_torch.format import AcmException
from libacm_tpu_torch.scan import native
from libacm_tpu_torch.stream import (AcmStream, DecodeState, _Window,
                                     acm_open_decoder)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native scanner unavailable")

ERRORS = (AcmException, JAcmException)


class PipeSource:
    """read()-only AcmIO: no seek, no length (like a network/VFS pipe)."""

    def __init__(self, data: bytes, trickle: int | None = None):
        self._b = io.BytesIO(data)
        self._trickle = trickle  # cap per-read size (slow producer)

    def read(self, size: int = -1) -> bytes:
        if self._trickle is not None:
            size = self._trickle if size < 0 else min(size, self._trickle)
        return self._b.read(size)


def _ref(data: bytes) -> AcmStream:
    """The port's whole-file stream, synthesis on the CPU."""
    return acm_open_decoder(data, device="cpu")


def _wins(data: bytes, wb: int, pipe: bool = False, trickle=None):
    """(the port's windowed stream, the JAX package's) over equal sources."""
    def src():
        return PipeSource(data, trickle) if pipe else io.BytesIO(data)

    return (AcmStream(src(), window_blocks=wb),
            jstream.AcmStream(src(), window_blocks=wb))


def _read(s, n):
    """read_loop's bytes, or the error code of the read that raised."""
    try:
        return s.read_loop(n)
    except ERRORS as e:
        return int(e.code)


def _drain(s, chunk: int) -> bytes:
    out = bytearray()
    while True:
        got = _read(s, chunk)
        if not isinstance(got, bytes) or not got:
            break
        out += got
    return bytes(out)


def _drain_past_errors(s, chunk: int = 4096) -> bytes:
    """Drain continuing past error events (each raise consumes one event,
    so this terminates)."""
    out = bytearray()
    while True:
        b = _read(s, chunk)
        if isinstance(b, int):
            continue
        if not b:
            return bytes(out)
        out += b


def _fuzz_stream(rng) -> bytes:
    level = int(rng.integers(0, 9))
    rows = int(rng.integers(1, 40))
    nb = int(rng.integers(1, 12))
    if rng.random() < 0.5:
        data = testing.speech_acm_bytes(
            rng, level=level, rows=rows, n_blocks=nb,
            channels=int(rng.integers(1, 3)), wavc=bool(rng.integers(0, 2)))
    else:
        data = testing.random_acm_bytes(
            rng, level=level, rows=rows, n_blocks=nb,
            channels=int(rng.integers(1, 3)), wavc=bool(rng.integers(0, 2)),
            max_pwr=int(rng.integers(0, 16)))
    mut = rng.random()
    if mut < 0.25 and len(data) > 20:
        data = data[: int(rng.integers(14, len(data)))]
    elif mut < 0.5:
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 5))):
            b[int(rng.integers(14, len(b)))] ^= 1 << int(rng.integers(0, 8))
        data = bytes(b)
    return data


def test_windowed_equals_slurped_fuzzed():
    """Byte-for-byte equality incl. truncated/corrupt/stale-amp streams,
    via a read()-only source (no length, no seek)."""
    rng = np.random.default_rng(20260816)
    n = 0
    for _ in range(60):
        data = _fuzz_stream(rng)
        try:
            ref = _ref(data)
        except AcmException:
            with pytest.raises(AcmException):
                AcmStream(PipeSource(data), window_blocks=3)
            with pytest.raises(JAcmException):
                jstream.AcmStream(PipeSource(data), window_blocks=3)
            continue
        want = _drain(ref, 8192)
        wb = int(rng.integers(1, 6))
        chunk = int(rng.integers(64, 16384))
        trickle = int(rng.integers(17, 4096)) if rng.random() < 0.5 else None
        s, j = _wins(data, wb, pipe=True, trickle=trickle)
        assert _drain(s, chunk) == want
        assert _drain(j, chunk) == want
        assert not s.seekable()  # no length capability
        n += 1
    assert n > 40


def test_windowed_error_surfacing():
    """An immediate decode error raises in every stream at the same read,
    with the same code."""
    rng = np.random.default_rng(5)
    data = testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=6)
    b = bytearray(data)
    for i in range(60, 70):
        b[i] ^= 0xFF
    data = bytes(b)
    ref = _ref(data)
    win, jwin = _wins(data, 2, pipe=True)
    bl2 = 2 * ref._header.block_len
    codes = 0
    while True:
        a, c, d = _read(ref, bl2), _read(win, bl2), _read(jwin, bl2)
        assert a == c == d
        codes += isinstance(a, int)
        if a == b"":
            break
    assert codes > 0


def test_windowed_raw_tell_parity():
    """raw_tell's closed-form reconstruction == the strict scan == the JAX
    package's, at every attempt boundary."""
    rng = np.random.default_rng(11)
    for _ in range(25):
        data = _fuzz_stream(rng)
        try:
            ref = _ref(data)
        except AcmException:
            continue
        win, jwin = _wins(data, 2)
        step = max(2, 2 * ((ref._header.block_len * 2) // 3) // 2 * 2)
        assert win.raw_tell() == jwin.raw_tell() == ref.raw_tell()
        while True:
            a, b, c = _read(ref, step), _read(win, step), _read(jwin, step)
            assert win.raw_tell() == jwin.raw_tell() == ref.raw_tell()
            assert a == b == c
            if not isinstance(a, bytes) or not a:
                break


def test_windowed_seek_parity():
    rng = np.random.default_rng(13)
    data = testing.speech_acm_bytes(rng, level=6, rows=12, n_blocks=20,
                                    channels=2)
    ref = _ref(data)
    win, jwin = _wins(data, 3)
    # forward seek
    assert win.seek_pcm(1500) == jwin.seek_pcm(1500) == ref.seek_pcm(1500)
    assert win.read_loop(4096) == jwin.read_loop(4096) == ref.read_loop(4096)
    # backward seek (reset + re-decode in windowed mode)
    assert win.seek_pcm(100) == jwin.seek_pcm(100) == ref.seek_pcm(100)
    assert win.raw_tell() == jwin.raw_tell() == ref.raw_tell()
    assert win.read_loop(8192) == jwin.read_loop(8192) == ref.read_loop(8192)
    assert win.raw_tell() == jwin.raw_tell() == ref.raw_tell()
    assert _drain(win, 4096) == _drain(jwin, 4096) == _drain(ref, 4096)


def test_windowed_seek_requires_seekable():
    rng = np.random.default_rng(17)
    data = testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=8)
    s, j = _wins(data, 2, pipe=True)
    for x in (s, j):
        x.read_loop(x._header.block_len * 2)
        x.read_loop(x._header.block_len * 2)
    with pytest.raises(AcmException) as et:
        s.seek_pcm(0)
    with pytest.raises(JAcmException) as ej:
        j.seek_pcm(0)
    assert int(et.value.code) == int(ej.value.code)


def test_windowed_memory_bounded():
    """A long stream decodes in O(window) residency, not O(file), with the
    same residency as the JAX package's window."""
    rng = np.random.default_rng(19)
    data = testing.speech_acm_bytes(rng, level=7, rows=16, n_blocks=400)
    assert len(data) > 100_000
    s, j = _wins(data, 4, pipe=True)
    block_bytes = 2 * s._header.block_len
    assert _Window.CHUNK == jstream._Window.CHUNK
    bound = 3 * _Window.CHUNK + 8 * block_bytes
    peak = 0
    out = bytearray()
    while True:
        got = s.read_loop(8192)
        assert got == j.read_loop(8192)
        if not got:
            break
        out += got
        assert s._win.resident_bytes() == j._win.resident_bytes()
        peak = max(peak, s._win.resident_bytes())
    assert len(out) == 2 * 400 * s._header.block_len
    assert peak < bound, (peak, bound)
    assert bytes(out) == _drain(_ref(data), 65536)


def test_windowed_telemetry_and_state():
    rng = np.random.default_rng(23)
    data = testing.speech_acm_bytes(rng, level=5, rows=10, n_blocks=10,
                                    rate=22050)
    ref = _ref(data)
    win, jwin = _wins(data, 2)
    assert ((win.pcm_total(), win.time_total())
            == (jwin.pcm_total(), jwin.time_total())
            == (ref.pcm_total(), ref.time_total()))
    for s in (ref, win, jwin):
        s.read_loop(5000)
    assert win.pcm_tell() == jwin.pcm_tell() == ref.pcm_tell()
    assert win.time_tell() == jwin.time_tell() == ref.time_tell()


def test_player_simulation_interactive_seek():
    """The player-plugin usage shape: a windowed stream driven in small
    playback chunks with interleaved forward/backward seeks produces
    exactly the bytes a slurped stream and the JAX package's window
    produce under the same schedule."""
    rng = np.random.default_rng(31)
    data = testing.speech_acm_bytes(rng, level=6, rows=16, n_blocks=25,
                                    channels=2, rate=44100)
    ref = _ref(data)
    win, jwin = _wins(data, 3)
    schedule = []  # (kind, arg) replay log for debugging
    chunk = 4096
    for _ in range(200):
        if rng.random() < 0.08:
            pos = int(rng.integers(0, ref.pcm_total()))
            schedule.append(("seek", pos))
            assert (win.seek_pcm(pos) == jwin.seek_pcm(pos)
                    == ref.seek_pcm(pos)), schedule[-3:]
            assert win.pcm_tell() == jwin.pcm_tell() == ref.pcm_tell()
        else:
            schedule.append(("read", chunk))
            a = ref.read_loop(chunk)
            assert a == win.read_loop(chunk) == jwin.read_loop(chunk), \
                schedule[-3:]
            if not a:
                break
    assert win.time_tell() == jwin.time_tell() == ref.time_tell()


def test_windowed_post_seek_raw_tell_fuzzed():
    """Post-seek raw_tell at EOF: reload boundaries restart at data_start,
    so the extent probe must be data_start-relative."""
    rng = np.random.default_rng(47)
    checked = 0
    for _ in range(120):
        data = _fuzz_stream(rng)
        try:
            ref = _ref(data)
        except AcmException:
            continue
        win, jwin = _wins(data, 2)
        for s in (ref, win, jwin):
            _drain(s, 4096)
        try:
            ref.seek_pcm(0)
        except AcmException:
            continue
        win.seek_pcm(0)
        jwin.seek_pcm(0)
        assert _drain(ref, 4096) == _drain(win, 4096) == _drain(jwin, 4096)
        assert win.raw_tell() == jwin.raw_tell() == ref.raw_tell()
        checked += 1
    assert checked > 60


@pytest.mark.parametrize("resume_in", ["torch", "jax"])
def test_windowed_state_resume(resume_in):
    """get_state/set_state in windowed mode: resume repositions the window
    (reset + replay) and reproduces exactly the bytes and telemetry the
    snapshotted stream would have produced — on a fresh stream (of the
    port, and of the JAX package fed the port's state as JSON) and on the
    same stream after the window pruned the snapshot's blocks, hostile
    streams included."""
    rng = np.random.default_rng(53)
    checked = 0
    for trial in range(30):
        data = _fuzz_stream(rng)
        try:
            s, j = _wins(data, 2)
        except ERRORS:
            continue
        for _ in range(int(rng.integers(0, 15))):
            a, b = _read(s, 4096), _read(j, 4096)
            assert a == b
            if a == b"":
                break
        st = s.get_state()
        assert st.to_json() == j.get_state().to_json(), trial
        want_tail = _drain_past_errors(s)
        want_tells = (s.raw_tell(), s.pcm_tell())
        assert _drain_past_errors(j) == want_tail
        assert (j.raw_tell(), j.pcm_tell()) == want_tells
        # fresh stream of the same bytes
        if resume_in == "torch":
            s2 = AcmStream(io.BytesIO(data), window_blocks=2)
            s2.set_state(DecodeState.from_json(st.to_json()))
        else:
            s2 = jstream.AcmStream(io.BytesIO(data), window_blocks=2)
            s2.set_state(jstream.DecodeState.from_json(st.to_json()))
        assert _drain_past_errors(s2) == want_tail, trial
        assert (s2.raw_tell(), s2.pcm_tell()) == want_tells, trial
        # same stream, backward (its window long since pruned the state)
        s.set_state(st)
        assert _drain_past_errors(s) == want_tail, trial
        checked += 1
    assert checked > 20


def test_windowed_state_resume_at_eof():
    """A snapshot taken after the terminal-EOF attempt restores cleanly
    (end_bits re-derived) including raw_tell, in either package."""
    rng = np.random.default_rng(59)
    data = testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=6)
    ref = _ref(data)
    _drain(ref, 4096)
    assert ref.read(4096) == b""  # provoke the terminal attempt
    s, j = _wins(data, 2)
    for x in (s, j):
        _drain(x, 4096)
        assert x.read(4096) == b""
    st = s.get_state()
    assert st.to_json() == j.get_state().to_json()
    s2, j2 = _wins(data, 2)
    s2.set_state(st)
    j2.set_state(jstream.DecodeState.from_json(st.to_json()))
    for x in (s2, j2):
        assert x.read(4096) == b""
        assert x.raw_tell() == ref.raw_tell()
        assert x.pcm_tell() == ref.pcm_tell()


def test_windowed_state_resume_pipe_forward_only():
    """Forward resume onto the same (unseekable) stream needs no seek;
    a backward resume without seek capability raises, with the JAX
    package's code."""
    rng = np.random.default_rng(61)
    data = testing.speech_acm_bytes(rng, level=5, rows=10, n_blocks=8)
    full = _drain(_ref(data), 4096)
    s, j = _wins(data, 2, pipe=True)
    bl2 = 2 * s._header.block_len
    for x in (s, j):
        x.read_loop(bl2)
    st_early = s.get_state()
    for x in (s, j):
        x.read_loop(bl2)
    st_late = s.get_state()
    assert st_late.to_json() == j.get_state().to_json()
    s.set_state(st_late)  # at the current position: a no-op replay
    tail = _drain(s, 4096)
    assert full.endswith(tail) and len(tail) == len(full) - 2 * bl2
    assert _drain(j, 4096) == tail
    s3, j3 = _wins(data, 2, pipe=True)
    for x in (s3, j3):
        x.read_loop(bl2)
        x.read_loop(bl2)
    with pytest.raises(AcmException) as et:
        s3.set_state(st_early)
    with pytest.raises(JAcmException) as ej:
        j3.set_state(jstream.DecodeState.from_json(st_early.to_json()))
    assert int(et.value.code) == int(ej.value.code)


def test_windowed_resume_after_seek_is_first_pass():
    """A forward set_state on a stream that seeked backward must not serve
    the window's dirty-table state: any pass history forces a reset +
    first-pass replay, matching a fresh-stream resume."""
    rng = np.random.default_rng(67)
    rows, cols = 8, 8
    k0 = rng.integers(-8, 8, (rows, cols)).astype(np.int32)
    k1 = rng.integers(-100, 100, (rows, cols)).astype(np.int32)
    blocks = [testing.BlockData(pwr=0, val=5, k=k0, fillers=[4] * cols),
              testing.BlockData(pwr=10, val=777, k=k1, fillers=[8] * cols),
              testing.BlockData(pwr=0, val=9, k=k0, fillers=[4] * cols)]
    data = testing.encode_acm(blocks, 3 * rows * cols, level=3, rows=rows)

    tails = []
    for cls, state in ((AcmStream, DecodeState),
                       (jstream.AcmStream, jstream.DecodeState)):
        s = cls(io.BytesIO(data), window_blocks=3)
        s.read_loop(32)
        st = s.get_state()
        _drain(s, 4096)
        s.seek_pcm(0)  # dirties the window's amp table
        s.set_state(st)
        tail_same = _drain(s, 4096)
        s2 = cls(io.BytesIO(data), window_blocks=3)
        s2.set_state(state.from_json(st.to_json()))
        tail_fresh = _drain(s2, 4096)
        assert tail_same == tail_fresh
        s3 = cls(io.BytesIO(data), window_blocks=3)
        s3.read_loop(32)
        assert _drain(s3, 4096) == tail_fresh  # the true first-pass tail
        tails.append(tail_fresh)
    assert tails[0] == tails[1]


def test_window_without_native_warns_loudly(monkeypatch):
    """window_blocks without the native scanner must NOT silently slurp:
    the stream warns (ResourceWarning) and then behaves as a whole-file
    decode, which synthesizes on a device: that one is resolved at the
    open like any whole-file stream's."""
    import torch

    rng = np.random.default_rng(7)
    data = testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=6)
    want = _drain(AcmStream(io.BytesIO(data), window_blocks=4), 4096)
    monkeypatch.setattr(native, "available", lambda: False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        s = AcmStream(io.BytesIO(data), window_blocks=4, device="cpu")
    assert any(issubclass(w.category, ResourceWarning) for w in rec)
    assert s._win is None  # whole-file fallback
    assert _drain(s, 4096) == want
    monkeypatch.delenv("LIBACM_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="LIBACM_TPU_TORCH_DEVICE"):
            AcmStream(io.BytesIO(data), window_blocks=4)
