"""decode_stream_device: the port on the CPU ≡ the JAX package.

Mirrors tests/test_corpus.py's stream-device cases: the block axis cut
over 1, 2 and 4 devices (rows >= 2, rows == 1, level 0), windowed against
full-file, bounded host residency, the hostile unseekable source, bits
past the declared blocks, no native scanner, buffer exports. Each case
feeds the same bytes to the JAX function. Tolerance 0: PCM, status and
filler words bit for bit; on one device the whole tensor is compared,
zero tail rows of the last window included, which the carry that reached
them decides.
"""

import gc
import io
import pathlib

import jax
import numpy as np
import pytest
import torch

from libacm_tpu import testing
from libacm_tpu.parallel import corpus as jcorpus
from libacm_tpu_torch import AcmError, AcmException
from libacm_tpu_torch.parallel import corpus as tcorpus
from libacm_tpu_torch.parallel import decode_stream_device

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"

#: (level, rows, blocks): the fused route's domain, rows == 1, level 0
GEOMETRIES = [(6, 16, 40), (5, 1, 30), (0, 64, 12)]


def _flat(pcm) -> np.ndarray:
    """The stream's PCM on the host: spans gathered in block order."""
    if isinstance(pcm, list):
        pcm = torch.cat([p.cpu() for p in pcm], dim=0)
    return pcm.cpu().numpy().reshape(-1)


def _jax_flat(pcm) -> np.ndarray:
    return np.asarray(jax.device_get(pcm)).reshape(-1)


def _stream(level, rows, nb, seed=33):
    return testing.speech_acm_bytes(np.random.default_rng(seed), level=level,
                                    rows=rows, n_blocks=nb)


class _Pipe:
    """read()-only source that tracks the largest single request."""

    def __init__(self, raw):
        self._b = io.BytesIO(raw)
        self.max_req = 0

    def read(self, n=-1):
        self.max_req = max(self.max_req, n)
        return self._b.read(n)


@pytest.mark.parametrize("level,rows,nb", GEOMETRIES)
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 8, 7])
def test_torch_stream_blocks_sharded_matches_jax(level, rows, nb, n, window):
    data = _stream(level, rows, nb)
    mesh = jcorpus.make_mesh(n, axis="blocks")
    want, wmeta = jcorpus.decode_stream_device(data, mesh=mesh, axis="blocks",
                                               window_blocks=window)
    pcm, meta = decode_stream_device(data, devices=["cpu"] * n,
                                     window_blocks=window)
    assert isinstance(pcm, list) == (n > 1)
    assert (meta.status, meta.filler_words) == (wmeta.status,
                                                wmeta.filler_words)
    assert meta.pcm is None and meta.info.acm_level == level
    got, want = _flat(pcm), _jax_flat(want)
    host = jcorpus.decode_corpus([data])[0].pcm
    np.testing.assert_array_equal(got[: len(host)], host)
    if n == 1:
        np.testing.assert_array_equal(got, want)  # tail rows too
    else:
        np.testing.assert_array_equal(got[: len(host)], want[: len(host)])


@pytest.mark.parametrize("level,rows,nb", GEOMETRIES)
def test_torch_stream_wire_chunks_identical(level, rows, nb):
    """The windowed scan yields the JAX package's wire chunks byte for
    byte (the power-of-two payload slices included)."""
    data = _stream(level, rows, nb, seed=5)

    def chunks(mod, native_mod):
        header = mod.parse_header(mod.BitReader(data))
        e = mod._FileEntry(index=0, src=data, header=header, nbytes=0,
                           channels=1)
        state = {"oor": False, "events": []}
        reader = mod._StreamReader(data[mod._stream_data_start(header):])
        out = [tuple(a.copy() for a in c)
               for c in mod._stream_wire_chunks(reader, e, 8, state)]
        return out, np.concatenate(state["events"]), e.n_good

    want, wev, wng = chunks(jcorpus, None)
    got, gev, gng = chunks(tcorpus, None)
    assert len(got) == len(want) and gng == wng == nb
    np.testing.assert_array_equal(gev, wev)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 4])
def test_torch_stream_windowed_bounded_memory(n):
    """One long stream through a read()-only source, windowed: byte-exact,
    and the source is never slurped."""
    data = testing.speech_acm_bytes(np.random.default_rng(44), level=5,
                                    rows=32, n_blocks=600)
    pipe, jpipe = _Pipe(data), _Pipe(data)
    pcm, meta = decode_stream_device(pipe, devices=["cpu"] * n,
                                     window_blocks=16)
    want, wmeta = jcorpus.decode_stream_device(
        jpipe, mesh=jcorpus.make_mesh(n, axis="blocks"), axis="blocks",
        window_blocks=16)
    assert meta.status == wmeta.status == 0
    assert meta.filler_words == wmeta.filler_words == 0
    host = jcorpus.decode_corpus([data])[0].pcm
    got = _flat(pcm)
    np.testing.assert_array_equal(got[: len(host)], host)
    np.testing.assert_array_equal(got[: len(host)],
                                  _jax_flat(want)[: len(host)])
    # requests stay at the 64 KiB IO granularity, far below the file size
    assert 0 < pipe.max_req <= 128 * 1024 < len(data)
    assert pipe.max_req == jpipe.max_req


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("n", [1, 2])
def test_torch_stream_windowed_matches_fullfile(cut, n):
    """Windowed and whole-file decode agree (status and filler too) on a
    clean and on a truncated stream, and with the JAX package."""
    data = testing.speech_acm_bytes(np.random.default_rng(45), level=4,
                                    rows=8, n_blocks=30)
    if cut:
        data = data[: int(len(data) * 0.8)]
    devs = ["cpu"] * n
    p_full, m_full = decode_stream_device(data, devices=devs)
    p_win, m_win = decode_stream_device(data, devices=devs, window_blocks=8)
    _, j_full = jcorpus.decode_stream_device(data)
    j_pcm, j_win = jcorpus.decode_stream_device(data, window_blocks=8)
    assert (m_full.status, m_full.filler_words) == (m_win.status,
                                                    m_win.filler_words)
    assert (m_win.status, m_win.filler_words) == (j_win.status,
                                                  j_win.filler_words)
    assert (m_full.status, m_full.filler_words) == (j_full.status,
                                                    j_full.filler_words)
    nf, nw = _flat(p_full), _flat(p_win)
    host = jcorpus.decode_corpus([data])[0].pcm
    np.testing.assert_array_equal(nf[: len(host)], host)
    np.testing.assert_array_equal(nw[: len(host)], host)
    if n == 1:
        np.testing.assert_array_equal(nw, _jax_flat(j_pcm))


@pytest.mark.parametrize("n", [1, 2])
def test_torch_stream_hostile_unseekable_source(n):
    """A stale-amp-table stream: re-readable sources fall back to the
    exact host decode; a consumed unseekable source raises the reference's
    ValueError; full-file mode uses the bytes it already holds."""
    data = (FIXTURES / "stale_table_fuzz_2103.acm").read_bytes()
    host = jcorpus.decode_corpus([data])[0]
    assert host.status == 0 and host.pcm is not None
    devs = ["cpu"] * n
    for wb in (None, 2, 4):
        pcm, meta = decode_stream_device(data, devices=devs,
                                         window_blocks=wb)
        _, jmeta = jcorpus.decode_stream_device(data, window_blocks=wb)
        np.testing.assert_array_equal(_flat(pcm)[: len(host.pcm)], host.pcm)
        assert (meta.status, meta.filler_words) == (jmeta.status,
                                                    jmeta.filler_words)
    pcm, _ = decode_stream_device(io.BytesIO(data), devices=devs,
                                  window_blocks=2)
    np.testing.assert_array_equal(_flat(pcm)[: len(host.pcm)], host.pcm)
    with pytest.raises(ValueError, match="stale-amp-table") as exc:
        decode_stream_device(_Pipe(data), devices=devs, window_blocks=2)
    with pytest.raises(ValueError, match="stale-amp-table") as jexc:
        jcorpus.decode_stream_device(_Pipe(data), window_blocks=2)
    assert str(exc.value) == str(jexc.value)
    pcm, meta = decode_stream_device(_Pipe(data), devices=devs)
    np.testing.assert_array_equal(_flat(pcm)[: len(host.pcm)], host.pcm)
    assert meta.status == host.status
    # a CLEAN stream from the same pipe type stays fine, in both modes
    clean = testing.speech_acm_bytes(np.random.default_rng(8), level=4,
                                     rows=8, n_blocks=6)
    want = jcorpus.decode_corpus([clean])[0].pcm
    for wb in (2, None):
        pcm, _ = decode_stream_device(_Pipe(clean), devices=devs,
                                      window_blocks=wb)
        np.testing.assert_array_equal(_flat(pcm)[: len(want)], want)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("window,pipe", [(None, False), (2, False),
                                         (1, True), (3, True)])
def test_torch_stream_ignores_bits_past_declared_blocks(n, window, pipe):
    """Trailing bits that parse as a doomed block attempt past the
    declared total_values: the status stays clean in every mode."""
    data = (FIXTURES / "trailing_bits_clean.acm").read_bytes()
    host = jcorpus.decode_corpus([data])[0]
    assert host.status == 0
    pcm, meta = decode_stream_device(_Pipe(data) if pipe else data,
                                     devices=["cpu"] * n,
                                     window_blocks=window)
    _, jmeta = jcorpus.decode_stream_device(
        _Pipe(data) if pipe else data, window_blocks=window)
    assert meta.status == jmeta.status == host.status
    assert meta.filler_words == jmeta.filler_words
    np.testing.assert_array_equal(_flat(pcm)[: len(host.pcm)], host.pcm)


@pytest.mark.parametrize("kind", ["bytes", "seekable", "pipe"])
def test_torch_stream_without_native_scanner(monkeypatch, kind):
    """With no native scanner every call routes through the exact oracle
    fallback, from a read()-only source too."""
    from libacm_tpu_torch.scan import native as tnative

    clean = testing.speech_acm_bytes(np.random.default_rng(41), level=4,
                                     rows=8, n_blocks=6)
    want = jcorpus.decode_corpus([clean])[0].pcm
    monkeypatch.setattr(tnative, "available", lambda: False)
    src = {"bytes": clean, "seekable": io.BytesIO(clean),
           "pipe": _Pipe(clean)}[kind]
    pcm, meta = decode_stream_device(src, device="cpu", window_blocks=2)
    np.testing.assert_array_equal(_flat(pcm)[: len(want)], want)
    assert meta.status == 0


def test_torch_stream_windowed_calls_release_buffer_exports():
    """The native calls' ctypes pointers must not keep an export of the
    byte window alive: with gc disabled the window still grows (the
    NEED_MORE_DATA path, forced by dense coefficients)."""
    data = testing.random_acm_bytes(np.random.default_rng(3), level=6,
                                    rows=24, n_blocks=120, max_pwr=14)
    expect = jcorpus.decode_corpus([data])[0]
    gc.disable()
    try:
        pcm, meta = decode_stream_device(data, device="cpu")
        assert meta.status == expect.status
        assert np.array_equal(_flat(pcm)[: len(expect.pcm)], expect.pcm)
        pcm, _ = decode_stream_device(_Pipe(data), device="cpu",
                                      window_blocks=16)
        assert np.array_equal(_flat(pcm)[: len(expect.pcm)], expect.pcm)
    finally:
        gc.enable()


def test_torch_stream_open_and_format_errors(tmp_path):
    for kw in ({}, {"window_blocks": 4}):
        with pytest.raises(AcmException) as exc:
            decode_stream_device(str(tmp_path / "missing.acm"),
                                 device="cpu", **kw)
        assert exc.value.code == AcmError.ERR_OPEN
        with pytest.raises(AcmException) as exc:
            decode_stream_device(b"not an ACM stream at all", device="cpu",
                                 **kw)
        assert exc.value.code == AcmError.ERR_NOT_ACM


def test_torch_stream_default_needs_card(monkeypatch):
    """device=None is the card: without one the call raises; it decodes
    on the CPU only through $LIBACM_TPU_TORCH_DEVICE or an explicit
    device."""
    data = _stream(4, 8, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_stream_device(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_stream_device(data, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="not both"):
        decode_stream_device(data, device="cpu", devices=["cpu"])
    monkeypatch.setenv("LIBACM_TPU_TORCH_DEVICE", "cpu")
    pcm, meta = decode_stream_device(data)
    assert pcm.device.type == "cpu" and meta.status == 0


def test_torch_stream_spans_lie_on_their_devices():
    """Several devices: a list of [span, block_len] tensors in block
    order, W rounded up to the device count."""
    data = _stream(4, 8, 21)
    pcm, _ = decode_stream_device(data, devices=["cpu"] * 4,
                                  window_blocks=6)  # W -> 8, spans of 2
    assert [tuple(p.shape) for p in pcm] == [(2, 128)] * 11
    assert all(p.dtype == torch.int16 for p in pcm)
