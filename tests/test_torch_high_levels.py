"""Uncommon geometries end to end through the port: level > 7 (cols >
128), level 0 (no filterbank), rows == 1 — tests/test_high_levels.py's
cases on libacm_tpu_torch, each ALSO held to the JAX package at
tolerance 0."""

import numpy as np
import pytest

from libacm_tpu import testing
from libacm_tpu.parallel import decode_corpus as jdecode_corpus
from libacm_tpu.stream import acm_open_decoder as jacm_open_decoder
from libacm_tpu_torch.parallel import decode_corpus, decode_corpus_device
from libacm_tpu_torch.scan import oracle
from libacm_tpu_torch.stream import acm_open_decoder


@pytest.mark.parametrize("level,rows,nb", [(8, 4, 3), (9, 2, 2), (0, 50, 4),
                                           (10, 1, 2)])
@pytest.mark.parametrize("route", ["device", "device_dense", "corpus",
                                   "host"])
def test_corpus_uncommon_geometries(level, rows, nb, route):
    rng = np.random.default_rng(level * 11 + rows)
    data = testing.random_acm_bytes(rng, level=level, rows=rows, n_blocks=nb,
                                    max_pwr=9)
    h, want, _ = oracle.decode_bytes(data)
    if route == "device":
        r = decode_corpus_device([data], device="cpu").to_results()[0]
    elif route == "device_dense":
        r = decode_corpus_device([data], device="cpu",
                                 pack=False).to_results()[0]
    elif route == "corpus":
        r = decode_corpus([data], device="cpu")[0]
    else:
        r = decode_corpus([data], backend="host")[0]
    assert r.ok
    np.testing.assert_array_equal(r.pcm, want[: len(r.pcm)])
    assert len(r.pcm) == h.total_values
    j = jdecode_corpus([data])[0]
    np.testing.assert_array_equal(r.pcm, j.pcm)
    assert (r.status, r.filler_words) == (j.status, j.filler_words)


@pytest.mark.parametrize("kw", [{"device": "cpu"}, {"window_blocks": 1}],
                         ids=["cpu", "windowed"])
def test_stream_level12(kw):
    rng = np.random.default_rng(3)
    data = testing.random_acm_bytes(rng, level=12, rows=1, n_blocks=1,
                                    max_pwr=4)
    h, want, _ = oracle.decode_bytes(data)
    got = acm_open_decoder(data, **kw).read_loop(10**8)
    np.testing.assert_array_equal(np.frombuffer(got, dtype="<i2"), want)
    assert got == jacm_open_decoder(data).read_loop(10**8)
