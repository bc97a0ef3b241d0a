"""The port's O(segment) random access ≡ the JAX package, bit for bit.

read_segment runs on both of the port's CPU routes — the device route on
device="cpu" (cols-wire unpack + the kernel wrapper's plain version) and
backend="host" (the fused native host decoder) — against the JAX
package's read_segment and the full sequential decode; tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from libacm_tpu import testing
from libacm_tpu.parallel import random_access as jra
from libacm_tpu_torch.parallel import random_access as tra
from libacm_tpu_torch.parallel import (BlockIndex, RandomAccessCorpus,
                                       build_index, read_segment)
from libacm_tpu_torch.scan import native, oracle

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native scanner did not build")

#: read_segment keyword arguments of the port's two CPU routes
ROUTES = {"device": {"device": "cpu"}, "host": {"backend": "host"}}


@pytest.fixture(params=sorted(ROUTES))
def route(request):
    return ROUTES[request.param]


@pytest.mark.parametrize("level,rows,nb", [
    (4, 16, 8), (7, 16, 5), (2, 2, 6), (3, 100, 4), (5, 3, 7), (3, 1, 10),
    (0, 64, 6),
])
def test_random_windows_like_jax(level, rows, nb, route):
    rng = np.random.default_rng(level * 7 + rows)
    data = testing.random_acm_bytes(rng, level=level, rows=rows, n_blocks=nb,
                                    max_pwr=12)
    _, want, _ = oracle.decode_bytes(data)
    idx = build_index(data)
    jidx = jra.build_index(data)
    assert idx.n_good == jidx.n_good == nb
    np.testing.assert_array_equal(idx.bitpos, jidx.bitpos)
    bl = idx.header.block_len
    cases = [(0, 10), (bl - 3, 7), (bl, bl), (len(want) - 9, 100),
             (len(want), 5), (0, len(want)), (3, len(want) * 2)]
    for _ in range(12):
        s = int(rng.integers(0, len(want)))
        cases.append((s, int(rng.integers(1, 3 * bl))))
    for start, n in cases:
        got = read_segment(data, idx, start, n, **route)
        np.testing.assert_array_equal(
            got, jra.read_segment(data, jidx, start, n),
            err_msg=f"segment ({start}, {n})")
        np.testing.assert_array_equal(
            got, want[start : min(start + n, len(want))])


def test_truncated_stream_index(route):
    rng = np.random.default_rng(9)
    data = testing.random_acm_bytes(rng, level=3, rows=20, n_blocks=6)
    cut = data[: len(data) * 2 // 3]
    idx = build_index(cut)
    assert idx.n_good < 6
    _, want, _ = oracle.decode_bytes(cut)
    avail = idx.n_good * idx.header.block_len
    np.testing.assert_array_equal(
        read_segment(cut, idx, avail - 50, 200, **route),
        want[avail - 50 : avail])


def test_stale_amp_table_stream_like_jax(route, fixtures_dir):
    """A stream whose coefficients leave the amp table (index.oor) is
    served from an exact full host decode on both routes."""
    data = (fixtures_dir / "stale_table_fuzz_2103.acm").read_bytes()
    idx = build_index(data)
    assert idx.oor
    jidx = jra.build_index(data)
    for start, n in ((0, 100), (700, 3000), (5, 10**6)):
        np.testing.assert_array_equal(
            read_segment(data, idx, start, n, **route),
            jra.read_segment(data, jidx, start, n))


def test_stale_index_raises(route):
    """An index that no longer fits the bytes (the file was rewritten
    under a cached index) raises on both routes, never serves PCM."""
    rng = np.random.default_rng(31)
    data = testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=10)
    idx = build_index(data)
    cut = data[: len(data) // 2]
    with pytest.raises(ValueError, match="stale BlockIndex"):
        read_segment(cut, idx, 6 * idx.header.block_len, 500, **route)


def test_block_index_bytes_cross_packages():
    """A BlockIndex serialized by either package loads in the other with
    every field equal, and serves the same segments."""
    rng = np.random.default_rng(13)
    clean = testing.speech_acm_bytes(rng, level=5, rows=12, n_blocks=9,
                                     channels=2, rate=44100, wavc=True)
    trunc = testing.speech_acm_bytes(rng, level=3, rows=8, n_blocks=8)
    trunc = trunc[: int(len(trunc) * 0.6)]
    for data in (clean, trunc):
        jidx = jra.build_index(data)
        tidx = build_index(data)
        assert tidx.to_bytes() == jidx.to_bytes()
        got = BlockIndex.from_bytes(jidx.to_bytes())
        back = jra.BlockIndex.from_bytes(tidx.to_bytes())
        for a in (got, back):
            assert dataclasses.asdict(a.header) == dataclasses.asdict(
                jidx.header)
            assert (a.n_good, a.first_err, a.oor) == (
                jidx.n_good, jidx.first_err, jidx.oor)
            np.testing.assert_array_equal(a.bitpos, jidx.bitpos)
        np.testing.assert_array_equal(
            read_segment(data, got, 50, 200, device="cpu"),
            jra.read_segment(data, jidx, 50, 200))
    with pytest.raises(ValueError):
        BlockIndex.from_bytes(b"not an index")
    with pytest.raises(ValueError):
        BlockIndex.from_bytes(build_index(clean).to_bytes()[:-8])


def test_random_access_corpus_like_jax(tmp_path, route):
    rng = np.random.default_rng(12)
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.acm"
        p.write_bytes(testing.random_acm_bytes(
            rng, level=4, rows=16, n_blocks=4, channels=2 if i == 1 else 1))
        paths.append(str(p))
    rac = RandomAccessCorpus(paths, **route)
    jrac = jra.RandomAccessCorpus(paths)
    for i in range(3):
        assert rac.pcm_total(i) == jrac.pcm_total(i)
        for start, n in ((10, 50), (0, 1), (rac.pcm_total(i) - 5, 100)):
            got = rac.read(i, start, n)
            np.testing.assert_array_equal(got, jrac.read(i, start, n))
    assert rac.read(1, rac.pcm_total(1) - 5, 100).shape == (5, 2)


def test_random_access_corpus_lru_bounded(route):
    rng = np.random.default_rng(11)
    files = [testing.speech_acm_bytes(rng, level=3, rows=8, n_blocks=6)
             for _ in range(12)]
    rac = RandomAccessCorpus(files, max_cached_files=3, **route)
    want = {}
    for i in range(len(files)):
        want[i] = rac.read(i, 2, 40).copy()
        assert rac.cached_files <= 3
    assert len(rac._index_lru) == len(files)
    for i in reversed(range(len(files))):
        np.testing.assert_array_equal(rac.read(i, 2, 40), want[i])
        assert rac.cached_files <= 3


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_index_dir_across_packages(tmp_path, monkeypatch, writer):
    """An index_dir store written by one package is read by the other
    without a rebuild and serves identical PCM; a corrupt entry is
    rebuilt, not trusted."""
    rng = np.random.default_rng(14)
    files = [testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=7)
             for _ in range(3)]
    store = tmp_path / "idx"
    first = (jra.RandomAccessCorpus(files, index_dir=store) if writer == "jax"
             else RandomAccessCorpus(files, index_dir=store, device="cpu"))
    want = [first.read(i, 3, 50).copy() for i in range(3)]
    blobs = sorted(store.glob("*.abix"))
    assert len(blobs) == 3

    def no_rebuild(data):
        raise AssertionError("index rebuilt despite store hit")

    with monkeypatch.context() as m:
        m.setattr(tra, "build_index", no_rebuild)
        m.setattr(jra, "build_index", no_rebuild)
        second = (RandomAccessCorpus(files, index_dir=store, device="cpu")
                  if writer == "jax"
                  else jra.RandomAccessCorpus(files, index_dir=store))
        for i in range(3):
            np.testing.assert_array_equal(second.read(i, 3, 50), want[i])
    blobs[0].write_bytes(b"garbage")
    third = RandomAccessCorpus(files, index_dir=store, device="cpu")
    for i in range(3):
        np.testing.assert_array_equal(third.read(i, 3, 50), want[i])


def test_random_access_corpus_thread_safety():
    import concurrent.futures

    rng = np.random.default_rng(15)
    files = [testing.speech_acm_bytes(rng, level=3, rows=8, n_blocks=5)
             for _ in range(6)]
    rac = RandomAccessCorpus(files, max_cached_files=2, device="cpu")
    want = [rac.read(i, 1, 30).copy() for i in range(6)]
    order = rng.integers(0, 6, 120).tolist()
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(lambda i: (i, rac.read(i, 1, 30)), order))
    for i, g in got:
        np.testing.assert_array_equal(g, want[i])
    assert rac.cached_files <= 2


def test_default_needs_card(monkeypatch):
    """read_segment and RandomAccessCorpus default to the card: without
    one they raise, unless the caller asks for the CPU."""
    rng = np.random.default_rng(16)
    data = testing.speech_acm_bytes(rng, level=3, rows=8, n_blocks=4)
    idx = build_index(data)
    monkeypatch.delenv("LIBACM_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        read_segment(data, idx, 0, 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        RandomAccessCorpus([data])
    want = read_segment(data, idx, 0, 100, backend="host")
    np.testing.assert_array_equal(
        RandomAccessCorpus([data], backend="host").read(0, 0, 100)[:, 0],
        want)
    monkeypatch.setenv("LIBACM_TPU_TORCH_DEVICE", "cpu")
    np.testing.assert_array_equal(read_segment(data, idx, 0, 100), want)


@pytest.mark.parametrize("backend", ["auto", "jax", "pallas", "torch"])
def test_other_backends_rejected(backend):
    data = testing.speech_acm_bytes(np.random.default_rng(17), level=3,
                                    rows=8, n_blocks=3)
    with pytest.raises(ValueError, match="backend"):
        read_segment(data, build_index(data), 0, 10, backend=backend)
    with pytest.raises(ValueError, match="backend"):
        RandomAccessCorpus([data], backend=backend)
