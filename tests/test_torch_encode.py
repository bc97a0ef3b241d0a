"""The port's encoder ≡ the JAX package's.

backend="numpy" is the same float64 host algorithm in both packages and
must give the same bytes. backend="torch" (float32 on the device, here
the CPU) replaces the JAX package's jitted float32 solve: it must meet
test_encode.py's round-trip quality bound, and its coefficients must stay
within 1 % of the largest JAX coefficient — two float32 conjugate-gradient
solves that sum in different orders; the JAX float32 and the numpy
float64 solves already differ by about 0.3 % on these inputs.
"""

import numpy as np
import pytest

from libacm_tpu import encode as jencode
from libacm_tpu import testing
from libacm_tpu_torch import acm_open_decoder, encode
from libacm_tpu_torch import io as tio
from libacm_tpu_torch.scan import oracle


def _snr(a, b):
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    noise = np.mean((a - b) ** 2)
    return 10 * np.log10(np.mean(a**2) / max(noise, 1e-12))


def _quiet_speech_pcm(seed, level=7, rows=16, nb=6):
    """In-image audio whose decode stays inside int16 (no output wrap)."""
    rng = np.random.default_rng(seed)
    blocks = testing.speech_blocks(rng, level, rows, nb, base_pwr=5,
                                   decay_cols=6)
    for b in blocks:
        b.val = int(rng.integers(50, 300))
        b.fillers = [testing.choose_filler_best(b.k[:, c])
                     for c in range(b.k.shape[1])]
    data = testing.encode_acm(blocks, nb * rows * (1 << level), level=level,
                              rows=rows)
    return oracle.decode_bytes(data)[1]


@pytest.mark.parametrize("level,rows,nb,pwr,cut", [
    (7, 16, 3, 13, None), (3, 10, 5, 15, 333), (5, 8, 4, 10, None),
])
def test_numpy_backend_bytes_equal_jax(level, rows, nb, pwr, cut):
    pcm = _quiet_speech_pcm(level + nb, level=level, rows=rows, nb=nb)[:cut]
    got = encode.encode_pcm(pcm, level=level, rows=rows, pwr=pwr)
    want = jencode.encode_pcm(pcm, level=level, rows=rows, pwr=pwr)
    assert got.data == want.data
    assert got.max_error == want.max_error


def test_torch_backend_quality_and_coefficients():
    pcm = _quiet_speech_pcm(11, nb=3)
    res = encode.encode_pcm(pcm, level=7, rows=16, pwr=13, backend="torch",
                            device="cpu")
    _, got, _ = oracle.decode_bytes(res.data)
    assert _snr(pcm, got) > 50
    assert int(np.abs(got.astype(np.int32) - pcm.astype(np.int32)).max()) \
        == res.max_error
    words = pcm.astype(np.int64) << 7
    wrap = np.zeros(254, np.int32)
    x = encode.analyze_ridge(words, 7, 48, wrap, backend="torch",
                             device="cpu")
    xj = jencode.analyze_ridge(words, 7, 48, wrap, backend="jax")
    assert np.isfinite(x).all()
    assert np.abs(x - xj).max() <= 1e-2 * np.abs(xj).max()


def test_other_backends_rejected():
    pcm = _quiet_speech_pcm(3, level=3, rows=8, nb=2)
    for backend in ("jax", "pallas", "auto"):
        with pytest.raises(ValueError, match="backend"):
            encode.encode_pcm(pcm, level=3, rows=8, backend=backend)


def test_wav_acm_decode_roundtrip(tmp_path):
    """WAV → ACM (the port's encoder) → decode (the port's stream)."""
    pcm = _quiet_speech_pcm(6, level=3, rows=10, nb=5)[:333]
    wav = tio.wav_header(len(pcm), 1, 22050) + pcm.astype("<i2").tobytes()
    ch, rate, back = tio.read_wav(wav)
    assert (ch, rate) == (1, 22050)
    res = encode.encode_pcm(back, level=3, rows=10, pwr=15, channels=ch,
                            rate=rate)
    s = acm_open_decoder(res.data, device="cpu")
    assert s.rate == 22050
    got = np.frombuffer(s.read_loop(10**7), dtype="<i2")
    assert got.shape == pcm.shape
    assert _snr(pcm, got) > 30.0


def test_exact_analysis_and_optimize_like_jax():
    rng = np.random.default_rng(1)
    level, rows = 4, 12
    cols = 1 << level
    k = rng.integers(-100, 100, (rows, cols)).astype(np.int32)
    wrap = rng.integers(-500, 500, 2 * cols - 2).astype(np.int32)
    words, wrap_out = oracle.synth_block(k, 37, level, wrap)
    x0, wrap_rec = encode.analyze_block(words, level, rows, wrap)
    np.testing.assert_array_equal(x0, (k * 37).reshape(-1))
    np.testing.assert_array_equal(wrap_rec, wrap_out)
    data = testing.random_acm_bytes(np.random.default_rng(7), level=5,
                                    rows=20, n_blocks=5)
    out = encode.optimize_acm(data)
    assert out == jencode.optimize_acm(data)
    assert len(out) < len(data)
    np.testing.assert_array_equal(oracle.decode_bytes(data)[1],
                                  oracle.decode_bytes(out)[1])
