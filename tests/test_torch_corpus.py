"""Device corpus decode: the port (device="cpu") ≡ the JAX package.

The corpus is the mixed one of __graft_entry__._dryrun_production_pipeline:
two bucket geometries, a truncated member and a non-ACM member, plus a
WAVC member, a rows == 1 stream and a level-0 stream so every route of
the port's synthesis dispatch is driven.
"""

from concurrent.futures import Future

import numpy as np
import pytest
import torch

from libacm_tpu import testing
from libacm_tpu.parallel import corpus as jcorpus
from libacm_tpu_torch.parallel import corpus as tcorpus


def _corpus():
    rng = np.random.default_rng(2026)
    files: list[bytes] = []
    for _ in range(5):
        files.append(testing.random_acm_bytes(rng, level=7, rows=16,
                                              n_blocks=3, max_pwr=14))
    for _ in range(4):
        files.append(testing.random_acm_bytes(rng, level=3, rows=16,
                                              n_blocks=4, max_pwr=12))
    files.append(files[0][: len(files[0]) // 2])
    files.append(b"not an ACM stream")
    files.append(testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=5,
                                          channels=2, wavc=True))
    files.append(testing.random_acm_bytes(rng, level=5, rows=1, n_blocks=9))
    files.append(testing.random_acm_bytes(rng, level=0, rows=64, n_blocks=3))
    return files


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.index == g.index
        assert w.status == g.status, w.index
        assert w.filler_words == g.filler_words, w.index
        if w.pcm is None:
            assert g.pcm is None
        else:
            np.testing.assert_array_equal(w.pcm, g.pcm)
        assert (w.info is None) == (g.info is None)
        if w.info is not None:
            assert w.info.channels == g.info.channels
            assert w.info.rate == g.info.rate


@pytest.mark.parametrize("pack,chunk_files", [(True, None), (True, 1),
                                               (False, None), (False, 2)])
def test_torch_device_corpus_matches_jax(pack, chunk_files):
    files = _corpus()
    want = jcorpus.decode_corpus_device(files, backend="jax",
                                        pack=pack).to_results()
    dc = tcorpus.decode_corpus_device(files, device="cpu", pack=pack,
                                      chunk_files=chunk_files)
    _assert_same(want, dc.to_results())
    assert dc.summary.n_files == len(files)
    assert dc.summary.n_failed == 1
    for idx, pcm in dc.device_arrays():
        assert pcm.device.type == "cpu" and pcm.dtype == torch.int16


def test_torch_device_corpus_without_native_scanner(monkeypatch):
    """Without the C++ scanner the corpus takes the dense path: oracle
    scan, per-block width-class packing, unpack on the device."""
    from libacm_tpu_torch.scan import native as tnative

    files = _corpus()
    want = jcorpus.decode_corpus_device(files, backend="jax").to_results()
    monkeypatch.setattr(tnative, "available", lambda: False)
    got = tcorpus.decode_corpus_device(files, device="cpu")
    _assert_same(want, got.to_results())


def test_torch_device_checksum_matches_jax_for_any_chunking():
    files = _corpus()
    want = jcorpus.decode_corpus_device(files, backend="jax").checksum()
    for chunk_files in (None, 1, 3):
        got = tcorpus.decode_corpus_device(files, device="cpu",
                                           chunk_files=chunk_files)
        assert got.checksum() == want, chunk_files


def test_stale_amp_table_checksum_rule_in_both_packages():
    """A stale-amp-table file: checksum() is the digest of what lies on
    the device (the k*val synthesis of the file's slot), the same in both
    packages; to_results() holds the host decoder's exact PCM, the same
    in both packages; and for such a file the two describe different PCM."""
    import pathlib

    stale = (pathlib.Path(__file__).parent / "fixtures"
             / "stale_table_fuzz_2103.acm").read_bytes()
    clean = _corpus()[5]
    for files in ([stale], [clean, stale, clean]):
        jdc = jcorpus.decode_corpus_device(files, backend="jax")
        tdc = tcorpus.decode_corpus_device(files, device="cpu")
        host = tcorpus.decode_corpus_host(files)
        _assert_same(jcorpus.decode_corpus_host(files), host)
        _assert_same(host, tdc.to_results())
        _assert_same(host, jdc.to_results())
        assert tdc.checksum() == jdc.checksum()
        for chunk_files in (1, 2):
            assert tcorpus.decode_corpus_device(
                files, device="cpu",
                chunk_files=chunk_files).checksum() == jdc.checksum()

        def results_sum(results):
            return sum(int(r.pcm.astype(np.int64).sum())
                       for r in results) & 0xFFFFFFFF

        # the results' PCM of a clean file is a prefix of its device slot;
        # the stale file's is another decode altogether
        i = files.index(stale)
        [(idx, slot)] = [(ix, pcm) for ix, pcm in tdc.device_arrays()
                         if i in ix]
        on_device = slot[idx.index(i)].reshape(-1).numpy()
        got = tdc.to_results()[i].pcm
        assert not np.array_equal(on_device[: len(got)], got)
        assert tdc.checksum() != results_sum(host)


def test_torch_checksum_config_invariant():
    """As test_corpus.py::test_device_checksum_config_invariant: padded
    rows/blocks are masked, so chunking and packing leave it unchanged."""
    rng = np.random.default_rng(77)
    files = [testing.speech_acm_bytes(rng, level=4, rows=8,
                                      n_blocks=int(rng.integers(2, 9)))
             for _ in range(7)]
    base = tcorpus.decode_corpus_device(files, device="cpu").checksum()
    assert base == jcorpus.decode_corpus_device(files).checksum()
    for kw in ({"chunk_files": 2}, {"pack": False},
               {"config": tcorpus.CorpusConfig(chunk_files=3)}):
        assert base == tcorpus.decode_corpus_device(
            files, device="cpu", **kw).checksum()


def test_torch_decode_corpus_matches_host_and_jax(tmp_path, monkeypatch):
    files = _corpus()
    paths = []
    for i, data in enumerate(files):
        p = tmp_path / f"f{i}.acm"
        p.write_bytes(data)
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.acm"))
    host = tcorpus.decode_corpus_host(paths, workers=2)
    _assert_same(jcorpus.decode_corpus_host(paths), host)
    _assert_same(host, tcorpus.decode_corpus(paths, device="cpu"))
    _assert_same(host, tcorpus.decode_corpus(paths, backend="host"))
    assert host[-1].status == int(tcorpus.AcmError.ERR_OPEN)
    # without the native decoder, device="cpu" decodes through the device
    # path on the CPU and fetches
    from libacm_tpu_torch.scan import native as tnative

    monkeypatch.setattr(tnative, "available", lambda: False)
    _assert_same(host, tcorpus.decode_corpus(paths, device="cpu"))


def test_torch_device_default_needs_card(monkeypatch):
    """device=None is the card: with none present the decode raises and
    never carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcorpus.decode_corpus_device(_corpus()[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcorpus.decode_corpus(_corpus()[:2])


def test_torch_backend_resolution():
    """The device decides the synthesis route (the kernel on a card, its
    plain version on the CPU): no backend forces plain torch on a card."""
    files = _corpus()[:2]
    for backend in ("torch", "cuda", "pallas"):
        with pytest.raises(ValueError, match="backend"):
            tcorpus.decode_corpus(files, device="cpu", backend=backend)
    with pytest.raises(ValueError, match="backend"):
        tcorpus.decode_corpus(files, device="cuda", backend="host")
    with pytest.raises(ValueError, match="backend"):
        tcorpus.decode_corpus_device(
            files, device="cpu", config=tcorpus.CorpusConfig(backend="host"))
    with pytest.raises(TypeError):
        tcorpus.decode_corpus_device(files, device="cpu", backend="torch")


def test_torch_wire_pool_keyed_on_target_device():
    """CPU targets never pool (torch.from_numpy aliases); a card target
    pools per device and reuses a buffer only once it is free."""
    cpu = torch.device("cpu")
    a = tcorpus._acquire_wire_bufs(2, 8, 3, 4, cpu)
    b = tcorpus._acquire_wire_bufs(2, 8, 3, 4, cpu)
    assert a is not b
    dev = torch.device("cuda", 0)  # no card needed: nothing is allocated
    c = tcorpus._acquire_wire_bufs(2, 8, 3, 4, dev)
    c.fut = Future()
    c.fut.set_result(None)

    class _Busy:
        @staticmethod
        def query():
            return False

    c.copied = _Busy()
    assert tcorpus._acquire_wire_bufs(2, 8, 3, 4, dev) is not c
    c.copied = None
    assert tcorpus._acquire_wire_bufs(2, 8, 3, 4, dev) is c
    assert tcorpus._acquire_wire_bufs(2, 8, 3, 4,
                                      torch.device("cuda", 1)) is not c
