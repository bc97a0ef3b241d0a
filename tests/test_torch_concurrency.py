"""Concurrent seek/read on the port: tests/test_concurrency.py's cases on
libacm_tpu_torch, each ALSO held to the JAX package at tolerance 0.

One stream, one thread, callers serialize (the player plugins' handshake);
the native scanner copy's per-thread scratch pools are the one place a
data race could corrupt decode output. Every join has a time limit.
"""

import pathlib
import threading
import time

import numpy as np
import pytest

import libacm_tpu as jacm
from libacm_tpu import testing
from libacm_tpu.scan import native as jnative
from libacm_tpu_torch import acm_open_file, acm_read_loop, acm_seek_pcm
from libacm_tpu_torch.parallel import RandomAccessCorpus
from libacm_tpu_torch.scan import native

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
SPEECH = FIXTURES / "speech_22k_mono.acm"
MUSIC = FIXTURES / "music_44k_stereo.acm"


@pytest.mark.parametrize("mode", ["cpu", "windowed"])
def test_seek_read_handshake_two_threads(mode):
    """UI thread posts seek targets; decode thread performs them between
    reads. The interleaved event log must replay bit-exactly on a fresh
    single-threaded stream of the port and of the JAX package."""
    kw = {"device": "cpu"} if mode == "cpu" else {"window_blocks": 4}
    stream = acm_open_file(SPEECH, **kw)
    total = stream.pcm_total()
    assert total > 8192

    lock = threading.Lock()
    pending: list[int | None] = [None]
    seeker_done = threading.Event()
    events: list[tuple] = []  # reader-thread only; read after join

    def reader():
        while True:
            with lock:
                tgt, pending[0] = pending[0], None
            if tgt is not None:
                reached = acm_seek_pcm(stream, tgt)
                events.append(("seek", tgt, reached))
            data = acm_read_loop(stream, 4096)
            events.append(("data", data))
            if not isinstance(data, bytes) or not data:
                if seeker_done.is_set() and pending[0] is None:
                    return
                time.sleep(0.001)

    def seeker():
        rng = np.random.default_rng(42)
        for _ in range(12):
            with lock:
                pending[0] = int(rng.integers(0, total))
            time.sleep(0.002)
            # the first read synthesizes the whole file (slow in plain
            # torch on the CPU): give the reader up to 2 s to take a
            # target before the next one replaces it
            t_end = time.monotonic() + 2.0
            while pending[0] is not None and time.monotonic() < t_end:
                time.sleep(0.001)
        # park the reader at a known final position so it can drain to EOF
        with lock:
            pending[0] = total - 2048
        seeker_done.set()

    t_r = threading.Thread(target=reader, daemon=True)
    t_s = threading.Thread(target=seeker, daemon=True)
    t_r.start(), t_s.start()
    t_s.join(30), t_r.join(30)
    assert not t_r.is_alive() and not t_s.is_alive()
    assert sum(1 for e in events if e[0] == "seek") >= 5

    jkw = {} if mode == "cpu" else kw
    for ref, seek, read in (
            (acm_open_file(SPEECH, **kw), acm_seek_pcm, acm_read_loop),
            (jacm.acm_open_file(SPEECH, **jkw), jacm.acm_seek_pcm,
             jacm.acm_read_loop)):
        for ev in events:
            if ev[0] == "seek":
                _, tgt, reached = ev
                assert seek(ref, tgt) == reached
            else:
                assert read(ref, 4096) == ev[1]


@pytest.mark.parametrize("kw", [{"device": "cpu"}, {"backend": "host"}],
                         ids=["cpu", "host"])
def test_random_access_corpus_many_readers(kw):
    """N serving threads over one RandomAccessCorpus with evictions
    forced: every segment equals the single-threaded answer and the JAX
    package's."""
    from libacm_tpu.parallel.random_access import (
        RandomAccessCorpus as JRandomAccessCorpus)

    paths = [SPEECH, MUSIC, FIXTURES / "wavc_22k.acm",
             FIXTURES / "level0.acm"]
    corpus = RandomAccessCorpus(paths, max_cached_files=2, **kw)
    single = RandomAccessCorpus(paths, **kw)
    jsingle = JRandomAccessCorpus(paths)
    rng = np.random.default_rng(7)
    reqs = []
    for _ in range(80):
        i = int(rng.integers(0, len(paths)))
        total = single.pcm_total(i)
        start = int(rng.integers(0, max(total - 8, 1)))
        n = int(rng.integers(1, 2048))
        want = single.read(i, start, n)
        np.testing.assert_array_equal(want, jsingle.read(i, start, n))
        reqs.append((i, start, n, want))

    errors: list[Exception] = []

    def worker(shard):
        try:
            for i, start, n, expect in shard:
                np.testing.assert_array_equal(corpus.read(i, start, n),
                                              expect)
        except Exception as exc:  # surfaced after join
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(reqs[k::4],),
                                daemon=True) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert corpus.cached_files <= 2


def test_packed_scan_parallel_scratch_pools():
    """scan_bytes_packed of the port's scanner copy under 4 threads x
    distinct geometries: the per-thread scratch reuse must never bleed
    between threads — every result bit-identical to the serial scan, and
    the serial scan to the JAX package's scanner."""
    if not native.available():
        pytest.skip("native scanner required")
    rng = np.random.default_rng(11)
    datas = [
        testing.random_acm_bytes(rng, level=7, rows=16, n_blocks=30,
                                 max_pwr=9),
        testing.random_acm_bytes(rng, level=2, rows=7, n_blocks=9),
        testing.random_acm_bytes(rng, level=10, rows=4, n_blocks=6),
        testing.random_acm_bytes(rng, level=4, rows=40, n_blocks=20),
    ]
    fields = ("cls", "pay4", "pay8", "pay16", "wid4", "wid8", "wid16",
              "pwr", "val", "events")
    serial = [{f: getattr(native.scan_bytes_packed(d), f).copy()
               for f in fields} for d in datas]
    for d, want in zip(datas, serial):
        got = jnative.scan_bytes_packed(d)
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f), want[f])

    errors: list[Exception] = []

    def worker(tid):
        try:
            order = list(range(len(datas)))
            for rep in range(12):
                for j in order[tid % len(order):] + order[:tid % len(order)]:
                    got = native.scan_bytes_packed(datas[j])
                    for f in fields:
                        np.testing.assert_array_equal(
                            getattr(got, f), serial[j][f],
                            err_msg=f"thread {tid} rep {rep} file {j} {f}")
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
