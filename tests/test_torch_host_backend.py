"""The fused native host decode path of the port's scanner copy
(`acm_decode_host`, `acm_synth_dense`): tests/test_host_backend.py's cases
on libacm_tpu_torch.scan.native, each ALSO held to the JAX package at
tolerance 0. Thread joins have a time limit."""

import threading

import numpy as np
import pytest

from libacm_tpu import testing
from libacm_tpu.parallel import decode_corpus as jdecode_corpus
from libacm_tpu.scan import native as jnative
from libacm_tpu_torch.ops.synth_torch import decode_scan_result
from libacm_tpu_torch.parallel import CorpusConfig, decode_corpus
from libacm_tpu_torch.scan import native, oracle

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native scanner unavailable")


def _random_stream(rng):
    level = int(rng.integers(0, 9))
    rows = int(rng.integers(1, 256))
    nb = int(rng.integers(1, 7))
    data = testing.random_acm_bytes(
        rng, level=level, rows=rows, n_blocks=nb,
        channels=int(rng.integers(1, 3)), wavc=bool(rng.integers(0, 2)),
        max_pwr=15)
    if rng.integers(0, 3) == 0:  # truncate: EOF quirks
        data = data[: int(rng.integers(14, len(data) + 1))]
    if rng.integers(0, 3) == 0:  # corrupt payload: error events
        data = bytearray(data)
        pos = int(rng.integers(14, len(data))) if len(data) > 14 else 0
        if pos:
            data[pos] ^= 1 << int(rng.integers(0, 8))
        data = bytes(data)
    return data


def test_corpus_host_matches_device_backend():
    rng = np.random.default_rng(42)
    streams = [_random_stream(rng) for _ in range(30)]
    host = decode_corpus(streams, backend="host")
    dev = decode_corpus(streams, device="cpu")
    jhost = jdecode_corpus(streams, backend="host")
    for h, d, j in zip(host, dev, jhost):
        assert (h.status, h.filler_words) == (d.status, d.filler_words)
        assert (h.status, h.filler_words) == (j.status, j.filler_words)
        if h.pcm is None:
            assert d.pcm is None and j.pcm is None
        else:
            np.testing.assert_array_equal(h.pcm, d.pcm)
            np.testing.assert_array_equal(h.pcm, j.pcm)


def test_decode_host_matches_oracle_events_and_pcm():
    rng = np.random.default_rng(7)
    checked = 0
    for _ in range(25):
        data = _random_stream(rng)
        hdr = oracle.parse_header(oracle.BitReader(data))
        if hdr is None:
            continue
        hd = native.decode_host(data)
        jhd = jnative.decode_host(data)
        scan = oracle.scan_bytes(data)
        np.testing.assert_array_equal(hd.events, scan.events)
        np.testing.assert_array_equal(hd.events, jhd.events)
        assert hd.n_good == scan.n_blocks == jhd.n_good
        assert hd.status == scan.status == jhd.status
        assert hd.oor == jhd.oor
        np.testing.assert_array_equal(hd.pcm, jhd.pcm)
        checked += 1
        if hd.oor:
            continue  # callers use the oracle for stale-amp streams
        want = oracle.words_to_pcm(oracle.synth_all(scan), hdr.level)
        np.testing.assert_array_equal(hd.pcm, want.reshape(-1))
    assert checked > 15


@pytest.mark.parametrize("level,rows,nb", [(7, 16, 9), (0, 50, 5), (3, 1, 7),
                                           (5, 33, 4)])
def test_decode_host_windowed_resume(level, rows, nb):
    """Windowed decode (N blocks at a time, threading end_bit + wrap) must
    be byte-identical to the one-shot decode, and each window's carry and
    end bit to the JAX package's scanner."""
    rng = np.random.default_rng(3 + level)
    data = testing.speech_acm_bytes(rng, level=level, rows=rows, n_blocks=nb)
    full = native.decode_host(data)
    np.testing.assert_array_equal(full.pcm, jnative.decode_host(data).pcm)
    hdr = full.header
    wrap = np.zeros(max(2 * hdr.cols - 2, 1), dtype=np.uint32)
    bit = 8 * hdr.data_start
    got = []
    for _ in range(100):
        # each decoder gets its own copy of the carry: it is updated in
        # place
        w = native.decode_host(data, hdr, max_blocks=2, start_bit=bit,
                               wrap=wrap.copy())
        j = jnative.decode_host(data, hdr, max_blocks=2, start_bit=bit,
                                wrap=wrap.copy())
        np.testing.assert_array_equal(w.pcm, j.pcm)
        np.testing.assert_array_equal(w.wrap, j.wrap)
        assert (w.end_bit, w.status, w.n_good) == (j.end_bit, j.status,
                                                   j.n_good)
        got.append(w.pcm)
        wrap = w.wrap
        bit = w.end_bit
        if w.status != 0 or w.n_good == 0:
            break
    np.testing.assert_array_equal(np.concatenate(got), full.pcm)


@pytest.mark.parametrize("level,rows", [(7, 16), (4, 100), (0, 8), (8, 3)])
def test_synth_dense_matches_decode_scan_result(level, rows):
    from libacm_tpu.ops.synth_jax import decode_scan_result as jdecode

    rng = np.random.default_rng(11 + level)
    data = testing.speech_acm_bytes(rng, level=level, rows=rows, n_blocks=4)
    scan = native.scan_bytes(data)
    host = decode_scan_result(scan, backend="host")
    np.testing.assert_array_equal(host,
                                  decode_scan_result(scan, device="cpu"))
    np.testing.assert_array_equal(
        host, jdecode(jnative.scan_bytes(data), backend="jax"))


def test_decode_host_thread_safe():
    """Concurrent decode_host calls (same geometry) must not share
    scratch: the GIL is released inside acm_decode_host."""
    rng = np.random.default_rng(7)
    datas = [testing.speech_acm_bytes(rng, level=7, rows=16, n_blocks=40)
             for _ in range(4)]
    want = [native.decode_host(d).pcm.copy() for d in datas]
    for d, w in zip(datas, want):
        np.testing.assert_array_equal(w, jnative.decode_host(d).pcm)
    bad = []

    def worker(off):
        for i in range(40):
            j = (off + i) % len(datas)
            got = native.decode_host(datas[j]).pcm
            if not np.array_equal(got, want[j]):
                bad.append((off, i, j))

    ts = [threading.Thread(target=worker, args=(o,), daemon=True)
          for o in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts)
    assert not bad, bad[:5]


def test_corpus_config_force_chans_consistent_across_backends():
    """CorpusConfig.force_chans must reach every route the same way."""
    from libacm_tpu.parallel import CorpusConfig as JCorpusConfig

    rng = np.random.default_rng(9)
    data = testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=4,
                                    channels=1)
    r_host = decode_corpus([data], backend="host",
                           config=CorpusConfig(force_chans=2,
                                               backend="host"))[0]
    r_dev = decode_corpus([data], device="cpu",
                          config=CorpusConfig(force_chans=2))[0]
    r_jax = jdecode_corpus([data], config=JCorpusConfig(force_chans=2))[0]
    assert r_host.info.channels == r_dev.info.channels == 2
    assert r_jax.info.channels == 2
    assert np.array_equal(r_host.pcm, r_dev.pcm)
    assert np.array_equal(r_host.pcm, r_jax.pcm)
    assert r_host.filler_words == r_dev.filler_words == r_jax.filler_words


def test_synth_dense_avx_vs_scalar_scratch_paths():
    """The native synth picks AVX-512 bodies only on 64-byte-aligned
    scratch; deliberately MISALIGNED scratch must take the scalar bodies
    and produce identical PCM and carry, and both the JAX package's
    scanner's."""
    import ctypes

    from libacm_tpu.scan.native import _load as jload
    from libacm_tpu_torch.scan.native import _load, _ptr

    rng = np.random.default_rng(31)
    for level, rows, nb in [(4, 16, 5), (5, 9, 4), (7, 16, 3), (8, 4, 3),
                            (10, 4, 2), (6, 33, 3)]:
        cols = 1 << level
        n = rows * cols
        k = rng.integers(-2000, 2000, (nb, rows, cols)).astype(np.int16)
        vals = rng.integers(1, 30000, nb).astype(np.uint16)
        wrap0 = rng.integers(0, 1 << 32, max(2 * cols - 2, 1),
                             dtype=np.uint64).astype(np.uint32)

        def run(lib, mis: int):
            wrap = wrap0.copy()
            raw_x = np.zeros(n + cols + 64, dtype=np.uint32)
            raw_y = np.zeros(n + cols + 64, dtype=np.uint32)

            def buf(raw):
                # place the DATA area (base + cols words) at 64B + mis
                off = ((-(raw.ctypes.data + 4 * cols)) % 64) // 4 + mis
                return raw[off : off + n + cols]

            x, y = buf(raw_x), buf(raw_y)
            pcm = np.empty((nb, n), dtype=np.int16)
            lib.acm_synth_dense(
                _ptr(k, ctypes.c_int16), _ptr(vals, ctypes.c_uint16),
                nb, level, rows, _ptr(wrap, ctypes.c_uint32),
                _ptr(x, ctypes.c_uint32), _ptr(y, ctypes.c_uint32),
                _ptr(pcm, ctypes.c_int16))
            return pcm, wrap

        aligned = run(_load(), 0)
        for other in (run(_load(), 1), run(jload(), 0)):
            np.testing.assert_array_equal(aligned[0], other[0],
                                          err_msg=f"pcm level={level}")
            np.testing.assert_array_equal(aligned[1], other[1],
                                          err_msg=f"wrap level={level}")
