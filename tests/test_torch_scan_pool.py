"""The corpus path's scanner pool: the host scans of a decode run on a few
long-lived threads, one task a device group of a chunk, and the calling
thread hands the chunks to the submitter in order.

On the CPU, with the pool's size forced through `_scan_workers`: one
scanner thread and four give the same results, checksums, device arrays,
summary counts and bucket order on the tracing tests' mixed corpus
(clean, stale-table, truncated and not-ACM files), on one device and over
three; a scan or dispatch that fails raises from the decode, leaves no
wire buffer held, and the next decode is right; the pool is made once and
kept. The case marked `cuda` holds four scanner threads to one on one card
named four times, where the pooled buffers of two groups share a key.
"""

from __future__ import annotations

import os
import threading

import pytest
import torch

from libacm_tpu_torch.parallel import corpus as tcorpus
from test_torch_tracing import _files


def _decode(monkeypatch, workers: int, files, **kw):
    monkeypatch.setattr(tcorpus, "_scan_workers", lambda: workers)
    return tcorpus.decode_corpus_device(files, **kw)


def _layout(dc) -> list:
    """Each bucket's files, geometry and device, in the order they came."""
    return [(b.level, b.rows, [e.index for e in b.entries], b.pcm.device)
            for b in dc._buckets]


def _counts(dc) -> tuple:
    s = dc.summary
    return s.n_files, s.n_ok, s.n_failed, s.n_partial, s.samples


def _assert_identical(a, b) -> None:
    assert _layout(a) == _layout(b)
    assert _counts(a) == _counts(b)
    ra, rb = a.to_results(), b.to_results()
    assert [(r.index, r.status, r.filler_words) for r in ra] == [
        (r.index, r.status, r.filler_words) for r in rb]
    for x, y in zip(ra, rb):
        assert (x.pcm is None) == (y.pcm is None)
        if x.pcm is not None:
            assert x.pcm.tobytes() == y.pcm.tobytes()
    da, db = a.device_arrays(), b.device_arrays()
    assert len(da) == len(db)
    for (ia, pa), (ib, pb) in zip(da, db):
        assert list(ia) == list(ib)
        assert pa.dtype == pb.dtype and pa.shape == pb.shape
        assert torch.equal(pa.cpu(), pb.cpu())
    assert a.checksum() == b.checksum()


@pytest.mark.parametrize("chunk_files", [None, 1, 3],
                         ids=["auto", "chunk1", "chunk3"])
@pytest.mark.parametrize("kw", [dict(device="cpu"),
                                dict(devices=["cpu"] * 3)],
                         ids=["one", "three"])
def test_four_scanners_equal_one(monkeypatch, kw, chunk_files):
    files = _files(2)
    one = _decode(monkeypatch, 1, files, chunk_files=chunk_files, **kw)
    four = _decode(monkeypatch, 4, files, chunk_files=chunk_files, **kw)
    _assert_identical(one, four)
    assert one.summary.n_failed == 1 and one.summary.n_partial >= 1


def _pooled(monkeypatch) -> dict[int, list]:
    """Pool the CPU target's wire buffers as a card target would, one pool
    a scanner thread, and copy each blob as a copy to a card would (the
    CPU tensor aliases it). Returns the pools by thread."""
    pools: dict[int, list] = {}

    def acquire(b, nb, level, rows, device):
        pool = pools.setdefault(threading.get_ident(), [])
        for w in pool:
            if w.key == (b, nb, level, rows, device) and w.free():
                w.reset()
                return w
        w = tcorpus._WireBufs(b, nb, level, rows, device)
        pool.append(w)
        return w

    real_coalesce = tcorpus._coalesce_wire

    def copying_coalesce(arrays, wirebufs=None):
        blob, lens = real_coalesce(arrays, wirebufs)
        return blob.copy(), lens

    monkeypatch.setattr(tcorpus, "_acquire_wire_bufs", acquire)
    monkeypatch.setattr(tcorpus, "_coalesce_wire", copying_coalesce)
    return pools


@pytest.mark.parametrize("where", ["scan", "dispatch"])
@pytest.mark.parametrize("k", [0, 3, 8])
def test_a_failure_raises_and_leaves_nothing_held(monkeypatch, k, where):
    """The group (scan) or chunk (dispatch) that holds file k fails: the
    decode raises it, no buffer of any scanner thread's pool stays held,
    and the next decode is right."""
    files = _files(2)
    kw = dict(devices=["cpu"] * 2, chunk_files=1)
    want = _decode(monkeypatch, 1, files, **kw)
    pools = _pooled(monkeypatch)
    monkeypatch.setattr(tcorpus, "_scan_workers", lambda: 4)
    real_scan = tcorpus._scan_cols_wire
    real_dispatch = tcorpus._dispatch_cols_wire

    def scan(chunk, *args):
        if where == "scan" and any(e.index == k for e in chunk):
            raise RuntimeError("scan failed")
        return real_scan(chunk, *args)

    def dispatch(groups, *args, **kwargs):
        if where == "dispatch" and any(e.index == k for g in groups
                                       for e in g[0]):
            raise RuntimeError("dispatch failed")
        return real_dispatch(groups, *args, **kwargs)

    monkeypatch.setattr(tcorpus, "_scan_cols_wire", scan)
    monkeypatch.setattr(tcorpus, "_dispatch_cols_wire", dispatch)
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        tcorpus.decode_corpus_device(files, **kw)
    held = [w for pool in pools.values() for w in pool
            if w.fut is tcorpus._SCAN_HOLD]
    assert pools and not held
    monkeypatch.setattr(tcorpus, "_scan_cols_wire", real_scan)
    monkeypatch.setattr(tcorpus, "_dispatch_cols_wire", real_dispatch)
    again = tcorpus.decode_corpus_device(files, **kw)
    _assert_identical(want, again)
    assert not [w for pool in pools.values() for w in pool
                if w.fut is tcorpus._SCAN_HOLD]


@pytest.mark.parametrize("n_cpus,workers", [(1, 1), (2, 1), (3, 1), (4, 2),
                                            (8, 6), (64, 6)])
def test_scan_workers_follow_the_cpus_the_process_may_use(
        monkeypatch, n_cpus, workers):
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(n_cpus)), raising=False)
    assert tcorpus._scan_workers() == workers


def test_the_scanner_pool_is_made_once_and_kept(monkeypatch):
    monkeypatch.setattr(tcorpus, "_scan_workers", lambda: 3)
    n, pool = tcorpus._scanner()
    assert n == 3
    files = _files()
    threads: set[int] = set()
    real = tcorpus._scan_cols_wire

    def scan(*args):
        threads.add(threading.get_ident())
        return real(*args)

    monkeypatch.setattr(tcorpus, "_scan_cols_wire", scan)
    for _ in range(3):
        tcorpus.decode_corpus_device(files, device="cpu", chunk_files=1)
    assert tcorpus._scanner() == (3, pool)
    assert threading.get_ident() not in threads
    assert 1 <= len(threads) <= 3
    # asked for another size (a test's hook), or in a forked child: new
    monkeypatch.setattr(tcorpus, "_scan_workers", lambda: 2)
    assert tcorpus._scanner()[0] == 2
    monkeypatch.setattr(tcorpus, "_scan_workers", lambda: 3)
    n, again = tcorpus._scanner()
    assert n == 3 and again is not pool
    pid = os.getpid()
    monkeypatch.setattr(os, "getpid", lambda: pid + 1)
    assert tcorpus._scanner()[1] is not again


def test_dense_route_uses_no_scanner(monkeypatch):
    def no_pool():
        raise AssertionError("the dense route scans on the calling thread")

    monkeypatch.setattr(tcorpus, "_scanner", no_pool)
    dc = tcorpus.decode_corpus_device(_files(), device="cpu", pack=False)
    assert dc.summary.n_ok > 0 and dc.summary.scan_s == 0


@pytest.mark.cuda
def test_card_four_scanners_equal_one_on_one_card_named_four_times(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    files = _files(2) * 3
    kw = dict(devices=[torch.device("cuda", 0)] * 4, chunk_files=1)
    one = _decode(monkeypatch, 1, files, **kw)
    for _ in range(3):  # the pools' buffers reused from pass to pass
        four = _decode(monkeypatch, 4, files, **kw)
        _assert_identical(one, four)
    # a failed scan on the card releases the holds of the real pools
    seen = []
    real_acquire, real_scan = (tcorpus._acquire_wire_bufs,
                               tcorpus._scan_cols_wire)

    def acquire(*args):
        w = real_acquire(*args)
        seen.append(w)
        return w

    def scan(chunk, *args):
        if any(e.index == 5 for e in chunk):
            raise RuntimeError("scan failed")
        return real_scan(chunk, *args)

    monkeypatch.setattr(tcorpus, "_acquire_wire_bufs", acquire)
    monkeypatch.setattr(tcorpus, "_scan_cols_wire", scan)
    with pytest.raises(RuntimeError, match="scan failed"):
        tcorpus.decode_corpus_device(files, **kw)
    assert seen and not [w for w in seen if w.fut is tcorpus._SCAN_HOLD]
    monkeypatch.setattr(tcorpus, "_scan_cols_wire", real_scan)
    _assert_identical(one, tcorpus.decode_corpus_device(files, **kw))
