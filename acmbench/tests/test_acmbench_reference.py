"""The benchmark's plain reference (acmbench/reference) against the goldens
of the C reference (tests/goldens, read as data), against its own oracle
decoding every file whole, and its batched synthesis against the oracle's
block-by-block synthesis."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch

from acmbench.gen import pool as gen
from acmbench.harness import expect
from acmbench.reference import decode as ref
from acmbench.reference import oracle
from acmbench.reference.format import resolve_channels
from acmbench.tests import tiny

FIXTURES = tiny.REPO / "tests" / "fixtures"
GOLDENS = tiny.REPO / "tests" / "goldens"
RAW_GOLDENS = sorted(p.stem for p in GOLDENS.glob("*.raw"))


def _expected_whole(data: bytes) -> ref.Expected:
    h = ref.file_header(data)
    fs = ref.scan_file(data, h, resolve_channels(h.channels, h.wavc_file, 0))
    return ref.expected_files([fs], {}, [0], "cpu")[0]


@pytest.mark.parametrize("name", RAW_GOLDENS)
def test_reference_matches_the_c_reference_goldens(name):
    """acmtool -d -r writes the decoded words up to its stop, then the
    filler as zeros, and reports the filler in bytes."""
    e = _expected_whole((FIXTURES / f"{name}.acm").read_bytes())
    words = e.exact_pcm()[: e.stop].numpy().astype("<i2").tobytes()
    assert words + b"\0" * (2 * e.filler) == (
        GOLDENS / f"{name}.raw").read_bytes()
    m = re.search(r"filler_samples: (\d+)",
                  (GOLDENS / f"{name}.stderr").read_text())
    assert 2 * e.filler == (int(m.group(1)) if m else 0)


def test_stale_table_fixture_matches_the_oracle():
    data = (FIXTURES / "stale_table_fuzz_2103.acm").read_bytes()
    e = _expected_whole(data)
    _, pcm, _ = oracle.decode_bytes(data)
    assert e.exact is not None
    assert np.array_equal(e.exact_pcm()[: len(pcm)].numpy(), pcm)


def _config(hostile_files: int = 10) -> dict:
    cfg = tiny.shrink(json.loads(
        (tiny.REPO / "acmbench/configs/fallout-1000.json").read_text()))
    cfg["hostile"]["files"] = hostile_files
    return cfg


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**33 + 5])
def test_pool_reference_equals_a_whole_decode_of_every_file(seed):
    """Clean files from their pool's scan, hostile ones resumed mid-stream
    (BitReader.at_bit): the same events and PCM as the oracle decoding the
    file's bytes from bit 0, stale-table reads included."""
    corpus = gen.make_corpus(_config(), seed)
    exps = expect.expected(corpus, "cpu")
    for f, e in zip(corpus.files, exps):
        whole = oracle.scan_bytes(f.data)
        assert e.n_good == whole.n_blocks
        _, pcm, _ = oracle.decode_bytes(f.data)
        assert np.array_equal(e.exact_pcm()[: len(pcm)].numpy(), pcm)
        plain = oracle.ScanResult(**{**whole.__dict__,
                                     "exc_block": whole.exc_block[:0]})
        words = oracle.words_to_pcm(oracle.synth_all(plain),
                                    whole.header.level)
        assert np.array_equal(e.pcm.numpy(), words)


@pytest.mark.parametrize("level,rows", [(0, 7), (1, 3), (3, 2), (7, 16),
                                        (10, 4), (13, 2), (15, 1)])
def test_batched_synthesis_equals_the_block_by_block_oracle(level, rows):
    rng = np.random.default_rng(level * 31 + rows)
    nb, cols = 5, 1 << level
    k = rng.integers(-2**15, 2**15, (2, nb, rows, cols)).astype(np.int16)
    val = rng.integers(0, 1 << 16, (2, nb))
    x = torch.from_numpy(k.reshape(2, nb, -1).astype(np.int64)
                         * val[..., None])
    x = ((x + 2**31) & 0xFFFFFFFF) - 2**31
    got = ref.synth(x.reshape(2, -1), level, rows).numpy()
    for b in range(2):
        wrap = np.zeros(max(2 * cols - 2, 0), np.int32)
        words = []
        for i in range(nb):
            w, wrap = oracle.synth_block(k[b, i], int(val[b, i]), level, wrap)
            words.append(w)
        assert np.array_equal(got[b], oracle.words_to_pcm(
            np.concatenate(words), level))


def test_at_bit_reader_holds_the_reservoir_of_a_reader_from_bit_0():
    data = bytes(np.random.default_rng(3).integers(0, 256, 64, np.uint8))
    r = oracle.BitReader(data)
    for n in [5, 20, 3, 31, 7, 12, 30, 1, 16, 24, 9]:
        pos = r.consumed_bits
        s = oracle.BitReader.at_bit(data, pos)
        assert (s._loaded_bits, s._avail, s._res) == (
            r._loaded_bits, r._avail, r._res)
        r.get(n)
