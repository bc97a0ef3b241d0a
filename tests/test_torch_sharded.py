"""Corpus decode sharded over a device list: the port
(`devices=["cpu"] * n`) ≡ one device ≡ the JAX package over its mesh.

Mirrors tests/test_corpus.py's sharded cases (sharded against unsharded,
uneven groups with truncated and corrupt members, the checksum invariant,
the hold on pooled wire buffers between scan and dispatch). The JAX side
runs over the virtual CPU devices tests/conftest.py sets up. Tolerance 0:
PCM, status and filler words are compared bit for bit.
"""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from libacm_tpu import testing
from libacm_tpu.parallel import corpus as jcorpus
from libacm_tpu_torch import device as tdevice
from libacm_tpu_torch.parallel import corpus as tcorpus
from test_torch_corpus import _assert_same, _corpus

N_DEVICES = [1, 2, 3, 8]


def _mixed(seed=7, n=10):
    """tests/test_corpus.py::_corpus: levels 0-5, rows 1-39, 1-5 blocks."""
    rng = np.random.default_rng(seed)
    files = []
    for _ in range(n):
        level = int(rng.choice([0, 2, 4, 5]))
        rows = int(rng.integers(1, 40))
        nb = int(rng.integers(1, 6))
        even = (rows * (1 << level)) % 2 == 0
        files.append(testing.random_acm_bytes(
            rng, level=level, rows=rows, n_blocks=nb,
            channels=int(rng.integers(1, 3)) if even else 1))
    return files


def _hostile(n=11):
    """11 files of two geometries, every fourth truncated or corrupt."""
    rng = np.random.default_rng(21)
    files = []
    for i in range(n):
        data = testing.speech_acm_bytes(
            rng, level=int(rng.choice([3, 6])), rows=16, n_blocks=4,
            channels=int(rng.integers(1, 3)))
        if i % 4 == 1:
            data = data[: len(data) - 10]  # truncated
        elif i % 4 == 2:
            b = bytearray(data)
            b[40] ^= 0xFF  # corrupt
            data = bytes(b)
        files.append(data)
    return files


@pytest.mark.parametrize("n", N_DEVICES)
def test_torch_sharded_matches_unsharded_and_jax_mesh(n):
    files = _mixed()
    want = jcorpus.decode_corpus(files, mesh=jcorpus.make_mesh())
    one = tcorpus.decode_corpus(files, device="cpu")
    got = tcorpus.decode_corpus(files, devices=["cpu"] * n)
    _assert_same(want, got)
    _assert_same(one, got)


@pytest.mark.parametrize("n", N_DEVICES)
@pytest.mark.parametrize("chunk_files", [None, 1, 2])
def test_torch_sharded_hostile_and_uneven(n, chunk_files):
    """Groups that do not divide the chunk (some short, some empty), with
    truncated and corrupt members."""
    files = _hostile()
    want = jcorpus.decode_corpus(files, mesh=jcorpus.make_mesh())
    dc = tcorpus.decode_corpus_device(files, devices=["cpu"] * n,
                                      chunk_files=chunk_files)
    _assert_same(want, dc.to_results())
    assert dc.summary.n_files == len(files)
    assert len(dc.devices) == n
    assert sorted(i for idx, _ in dc.device_arrays() for i in idx) == list(
        range(len(files)))


@pytest.mark.parametrize("n", N_DEVICES)
@pytest.mark.parametrize("pack", [True, False])
def test_torch_sharded_mixed_corpus_matches_jax(n, pack):
    """The mixed corpus of test_torch_corpus.py (two geometries, a
    truncated, a non-ACM and a WAVC member, rows == 1, level 0) through
    the wire route and the dense route."""
    files = _corpus()
    want = jcorpus.decode_corpus_device(files, backend="jax",
                                        mesh=jcorpus.make_mesh(),
                                        pack=pack).to_results()
    got = tcorpus.decode_corpus_device(files, devices=["cpu"] * n,
                                       pack=pack, chunk_files=2)
    _assert_same(want, got.to_results())
    assert got.summary.n_failed == 1


@pytest.mark.parametrize("n", N_DEVICES)
def test_torch_sharded_checksum_invariant(n):
    """checksum() sums per device and adds on the host: the same digest
    as one device and as the JAX package, over its mesh too."""
    rng = np.random.default_rng(77)
    files = [testing.speech_acm_bytes(rng, level=4, rows=8,
                                      n_blocks=int(rng.integers(2, 9)))
             for _ in range(7)]
    base = tcorpus.decode_corpus_device(files, device="cpu").checksum()
    assert base == jcorpus.decode_corpus_device(
        files, mesh=jcorpus.make_mesh()).checksum()
    devs = ["cpu"] * n
    for kw in ({}, {"chunk_files": 1}, {"pack": False}):
        assert base == tcorpus.decode_corpus_device(
            files, devices=devs, **kw).checksum(), kw


def test_torch_sharded_without_native_scanner(monkeypatch):
    from libacm_tpu_torch.scan import native as tnative

    files = _corpus()
    want = tcorpus.decode_corpus_device(files, device="cpu").to_results()
    monkeypatch.setattr(tnative, "available", lambda: False)
    got = tcorpus.decode_corpus_device(files, devices=["cpu"] * 3)
    _assert_same(want, got.to_results())


def test_torch_wire_pool_hold_blocks_reuse_between_scan_and_dispatch(
        monkeypatch):
    """As tests/test_corpus.py's hold test. All groups of a chunk are
    scanned BEFORE the dispatch future exists; two groups share a pool key
    when the list names a device twice, so without the _SCAN_HOLD pin the
    pool would hand group s's buffers to group s+1."""
    monkeypatch.setattr(tcorpus._SCAN_TLS, "wire_pool", [], raising=False)
    dev = torch.device("cuda", 0)  # no card needed: nothing is allocated
    w1 = tcorpus._acquire_wire_bufs(2, 4, 3, 8, dev)
    w1.fut = tcorpus._SCAN_HOLD
    w2 = tcorpus._acquire_wire_bufs(2, 4, 3, 8, dev)
    assert w2 is not w1  # held buffer must not be reused
    w1.fut = None
    w2.fut = None
    w3 = tcorpus._acquire_wire_bufs(2, 4, 3, 8, dev)
    assert w3 is w1 or w3 is w2  # released buffers ARE reused


def test_torch_sharded_holds_every_group_until_dispatch(monkeypatch):
    """One device named twice, pooling forced on: decode_corpus_device
    must pin each group's buffers as it scans the next, hand them all to
    the dispatch future, and release them when a scan fails."""
    files = _hostile(6)
    want = tcorpus.decode_corpus(files, device="cpu")
    monkeypatch.setattr(tcorpus, "_scan_workers", lambda: 4)
    pools: dict[int, list] = {}
    cpu = torch.device("cpu")
    seen = []

    def pooled_acquire(b, nb, level, rows, device):
        # pool as a card target would, one pool a scanner thread (the CPU
        # target never pools); every buffer acquired while an earlier
        # group waits must be another one
        pool = pools.setdefault(threading.get_ident(), [])
        for w in pool:
            if w.key == (b, nb, level, rows, device) and w.free():
                w.reset()
                seen.append(w)
                return w
        w = tcorpus._WireBufs(b, nb, level, rows, device)
        pool.append(w)
        seen.append(w)
        return w

    monkeypatch.setattr(tcorpus, "_acquire_wire_bufs", pooled_acquire)
    # the CPU tensor aliases the blob: copy it, as a card would
    real_coalesce = tcorpus._coalesce_wire

    def copying_coalesce(arrays, wirebufs=None):
        blob, lens = real_coalesce(arrays, wirebufs)
        return blob.copy(), lens

    monkeypatch.setattr(tcorpus, "_coalesce_wire", copying_coalesce)
    got = tcorpus.decode_corpus_device(files, devices=[cpu, cpu],
                                       chunk_files=1)
    _assert_same(want, got.to_results())
    assert len(seen) >= 2
    for w in seen:
        assert isinstance(w.fut, Future) and w.fut.done()

    # a failing scan releases the holds it took
    calls = []
    real_scan = tcorpus._scan_cols_wire

    def failing_scan(chunk, level, rows, nb, device):
        if calls:
            raise RuntimeError("scan failed")
        calls.append(1)
        return real_scan(chunk, level, rows, nb, device)

    monkeypatch.setattr(tcorpus, "_scan_cols_wire", failing_scan)
    del seen[:]
    with pytest.raises(RuntimeError, match="scan failed"):
        tcorpus.decode_corpus_device(files, devices=[cpu, cpu],
                                     chunk_files=1)
    assert seen and all(w.fut is not tcorpus._SCAN_HOLD for w in seen)


def test_torch_devices_argument_rules(monkeypatch):
    files = _corpus()[:2]
    with pytest.raises(ValueError, match="not both"):
        tcorpus.decode_corpus_device(files, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="empty"):
        tcorpus.decode_corpus_device(files, devices=[])
    with pytest.raises(ValueError, match="device list"):
        tcorpus.decode_corpus(files, devices=["cpu"], backend="host")
    # a list implies device decode: a DeviceCorpus is built even on the CPU
    called = []
    real = tcorpus.decode_corpus_device
    monkeypatch.setattr(tcorpus, "decode_corpus_device",
                        lambda *a, **k: called.append(k) or real(*a, **k))
    tcorpus.decode_corpus(files, devices=["cpu", "cpu"])
    assert called and called[0]["devices"] == ["cpu", "cpu"]


def test_torch_make_mesh_and_resolve_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert tdevice.resolve_devices("cpu") == [cpu]
    assert tdevice.resolve_devices(["cpu", cpu]) == [cpu, cpu]
    monkeypatch.setenv(tdevice.DEVICE_ENV, "cpu")
    assert tdevice.resolve_devices(None) == [cpu]
    assert tdevice.make_mesh() == [cpu]
    assert tdevice.make_mesh(3) == [cpu] * 3
    monkeypatch.delenv(tdevice.DEVICE_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tdevice.make_mesh, lambda: tdevice.resolve_devices(None),
                 lambda: tdevice.resolve_devices(["cpu", "cuda:0"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdevice.make_mesh() == [torch.device("cuda", i) for i in range(4)]
    assert tdevice.make_mesh(2) == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="cards"):
        tdevice.make_mesh(5)
