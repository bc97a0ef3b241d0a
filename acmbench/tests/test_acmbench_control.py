"""The check that decides `correct` has to fail what it exists to catch: the
control (the plain reference in float32 in the program's place) and each
fault a cell can have, planted under a run driven on the CPU (the chip
check skipped): a step that returns its state unchanged, half of the batch
left out, the exchange between cards left out, an answer altered where it
is produced."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import libacm_tpu_torch
from libacm_tpu_torch.ops import synth_torch
from libacm_tpu_torch.parallel import corpus as pcorpus
from libacm_tpu_torch.parallel import random_access

from acmbench import control
from acmbench.harness import bench
from acmbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("tiny"))


def _run(root, cell: str):
    spec = tiny.spec(root, cell)
    devices = [torch.device("cpu")] * int(spec.cell["chips"])
    return bench.run_cell(spec, tiny.SEED, 0.3, False, devices,
                          time.perf_counter())


@pytest.mark.parametrize("cell", ["fallout-1000.ingest",
                                  "fallout-1000.segments",
                                  "bg-music.tracks",
                                  "fallout-sharded-4.ingest"])
def test_sound_run_is_correct(root, cell):
    assert bench.correct(_run(root, cell))


@pytest.mark.parametrize("cell", ["fallout-1000.ingest",
                                  "fallout-1000.segments",
                                  "bg-music.tracks"])
@pytest.mark.parametrize("seed", [3, 2**32 + 8])
def test_float32_control_is_not_correct(root, cell, seed):
    checks = control.control_checks(tiny.spec(root, cell), seed, "cpu", 0.5)
    assert any(v > lim for v, lim in checks.values()), checks


# -- faults of the ingest cells ------------------------------------------


def _stale_corpus(monkeypatch):
    orig = libacm_tpu_torch.parallel.decode_corpus_device
    first = []

    def decode(srcs, **kw):
        if not first:
            first.append(orig(srcs, **kw))
        return first[0]

    monkeypatch.setattr(libacm_tpu_torch.parallel, "decode_corpus_device",
                        decode)


def _half_the_files(monkeypatch):
    orig = libacm_tpu_torch.parallel.decode_corpus_device
    monkeypatch.setattr(libacm_tpu_torch.parallel, "decode_corpus_device",
                        lambda srcs, **kw: orig(srcs[: len(srcs) // 2],
                                                **kw))


def _altered_sample(monkeypatch):
    orig = synth_torch.synth_pcm_cols_blob

    def synth(*a, **kw):
        pcm, carry = orig(*a, **kw)
        pcm.view(-1)[7] ^= 1
        return pcm, carry

    monkeypatch.setattr(synth_torch, "synth_pcm_cols_blob", synth)


def _first_card_only(monkeypatch):
    def checksum(self):
        n = len(self.devices)
        return pcorpus._sum_all(self._buckets[::n])

    monkeypatch.setattr(pcorpus.DeviceCorpus, "checksum", checksum)


INGEST_FAULTS = {"state unchanged": _stale_corpus,
                 "half the batch": _half_the_files,
                 "answer altered": _altered_sample}


@pytest.mark.parametrize("fault", sorted(INGEST_FAULTS))
@pytest.mark.parametrize("cell", ["fallout-1000.ingest",
                                  "fallout-sharded-4.ingest"])
def test_ingest_fault_is_not_correct(root, cell, fault, monkeypatch):
    INGEST_FAULTS[fault](monkeypatch)
    assert not bench.correct(_run(root, cell))


def test_sharded_exchange_left_out_is_not_correct(root, monkeypatch):
    _first_card_only(monkeypatch)
    assert not bench.correct(_run(root, "fallout-sharded-4.ingest"))


# -- faults of the segments cell -----------------------------------------


def _stale_segment(monkeypatch):
    orig = random_access.RandomAccessCorpus.read
    first = {}

    def read(self, i, s, n):
        out = orig(self, i, s, n)
        return first.setdefault("answer", out)

    monkeypatch.setattr(random_access.RandomAccessCorpus, "read", read)


def _half_the_requests(monkeypatch):
    orig = random_access.RandomAccessCorpus.read
    count = [0]

    def read(self, i, s, n):
        count[0] += 1
        out = orig(self, i, s, n)
        return out[:0] if count[0] % 2 else out

    monkeypatch.setattr(random_access.RandomAccessCorpus, "read", read)


def _altered_segment(monkeypatch):
    orig = random_access.read_segment

    def read_segment(*a, **kw):
        out = orig(*a, **kw).copy()
        if len(out):
            out[len(out) // 2] ^= 1
        return out

    monkeypatch.setattr(random_access, "read_segment", read_segment)


SEGMENT_FAULTS = {"state unchanged": _stale_segment,
                  "half the batch": _half_the_requests,
                  "answer altered": _altered_segment}


@pytest.mark.parametrize("fault", sorted(SEGMENT_FAULTS))
def test_segments_fault_is_not_correct(root, fault, monkeypatch):
    SEGMENT_FAULTS[fault](monkeypatch)
    assert not bench.correct(_run(root, "fallout-1000.segments"))


# -- faults of the tracks cell -------------------------------------------


def _stale_track(monkeypatch):
    orig = libacm_tpu_torch.acm_open_decoder
    first = []

    def open_decoder(data, **kw):
        first.append(data)
        return orig(first[0], **kw)

    monkeypatch.setattr(libacm_tpu_torch, "acm_open_decoder", open_decoder)


def _half_the_track(monkeypatch):
    orig = libacm_tpu_torch.AcmStream.read_loop

    def read_loop(self, n, *a, **kw):
        out = orig(self, n, *a, **kw)
        return out[: len(out) // 2 // 2 * 2] if len(out) > 2 else out

    monkeypatch.setattr(libacm_tpu_torch.AcmStream, "read_loop", read_loop)


def _altered_byte(monkeypatch):
    orig = libacm_tpu_torch.AcmStream.read_loop

    def read_loop(self, n, *a, **kw):
        out = bytearray(orig(self, n, *a, **kw))
        if out:
            out[-1] ^= 1
        return bytes(out)

    monkeypatch.setattr(libacm_tpu_torch.AcmStream, "read_loop", read_loop)


TRACK_FAULTS = {"state unchanged": _stale_track,
                "half the batch": _half_the_track,
                "answer altered": _altered_byte}


@pytest.mark.parametrize("fault", sorted(TRACK_FAULTS))
def test_tracks_fault_is_not_correct(root, fault, monkeypatch):
    TRACK_FAULTS[fault](monkeypatch)
    assert not bench.correct(_run(root, "bg-music.tracks"))


def test_control_pcm_differs_from_the_reference():
    """The control's float32 passes lose the low bits of large words."""
    from acmbench.reference import decode as ref

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-2**28, 2**28, (1, 4 * 2048)))
    exact = ref.synth(x, 7, 16)
    assert not torch.equal(exact, ref.synth(x, 7, 16, torch.float32))
