"""Closed-loop corpus ingest, one caller: the configuration's whole corpus,
in memory, through `decode_corpus_device` (PCM left on the card, or on the
cards of a list) and `checksum()`, in whole passes back to back.

Every pass decodes the same files in a new seeded order, so the work of
every pass and every seed is the same, and a result kept from an earlier
pass is a wrong answer, not a fast one. The window runs passes until
`--seconds` have passed; the rate is all decoded samples of those whole
passes over their time (host clock; each pass ends in checksum(), which
waits for the device).

Mix parameters (acmbench/traffic/<mix>.json): `pack` and `chunk_files`,
handed to decode_corpus_device as they are.

Check, once the window has closed: the last pass's PCM on the device,
file by file over every good block, and every file's status, words and
filler (DeviceCorpus.to_results) against the plain reference, and every
pass's checksum() against the reference's digest.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..gen.pool import Corpus, make_corpus
from ..harness import expect, roofline

ORDER_STREAM = 3  # SeedSequence child of the run's seed for pass orders


@dataclasses.dataclass
class State:
    corpus: Corpus
    files: list
    rng: np.random.Generator
    kwargs: dict
    passes: list = dataclasses.field(default_factory=list)
    last: tuple | None = None


def _decode(run, state: State, perm: np.ndarray):
    from libacm_tpu_torch.parallel import decode_corpus_device

    srcs = [state.files[i] for i in perm]
    with run.tracer.span("decode_corpus_device"):
        dc = decode_corpus_device(srcs, **state.kwargs)
    with run.tracer.span("checksum"):
        cs = dc.checksum()
    return dc, cs


def setup(run) -> State:
    corpus = make_corpus(run.spec.config, run.seed)
    rng = np.random.default_rng(
        np.random.SeedSequence(run.seed).spawn(ORDER_STREAM + 1)[-1])
    kwargs = dict(run.device_kwargs, pack=run.params.get("pack", True),
                  chunk_files=run.params.get("chunk_files"))
    state = State(corpus, [f.data for f in corpus.files], rng, kwargs)
    _decode(run, state, rng.permutation(len(state.files)))  # warm pass
    return state


def window(run, state: State) -> None:
    t0 = time.perf_counter()
    while True:
        perm = state.rng.permutation(len(state.files))
        state.last = None
        with run.tracer.span("pass"):
            t = time.perf_counter()
            dc, cs = _decode(run, state, perm)
            t1 = time.perf_counter()
        state.passes.append({"wall_s": round(t1 - t, 6),
                             "scan_s": round(dc.summary.scan_s, 6),
                             "checksum": cs})
        state.last = (dc, perm)
        if t1 - t0 >= run.seconds:
            return


def outputs(dc, perm: np.ndarray) -> tuple[dict, dict]:
    """The program's answers by file: ({file: its device row, flat}),
    ({file: (status, words, filler, host PCM)})."""
    rows = {}
    for idx, pcm in dc.device_arrays():
        for j, i in enumerate(idx):
            rows[int(perm[i])] = pcm[j].reshape(-1)
    results = {int(perm[r.index]): (r.status,
                                    0 if r.pcm is None else len(r.pcm),
                                    r.filler_words, r.pcm)
               for r in dc.to_results()}
    return rows, results


def compare(exps, rows: dict, results: dict, checksums: list) -> dict:
    """{name: (number of wrong answers, limit 0)} of the program's answers
    against the reference's."""
    want_digest = expect.digest(exps)
    pcm_wrong = status_wrong = length_wrong = 0
    for f, e in enumerate(exps):
        n = e.n_good * e.block_len
        row = rows.get(f)
        if row is None or row.numel() < n or not torch.equal(
                row[:n], e.pcm.to(row.device)):
            pcm_wrong += 1
        elif e.exact is not None:
            host = results.get(f, (0, 0, 0, None))[3]
            want = e.exact[: e.stop].cpu().numpy()
            if host is None or not np.array_equal(host, want):
                pcm_wrong += 1
        r = results.get(f)
        if r is None or r[0] != e.status:
            status_wrong += 1
        if r is None or r[1] != e.stop or r[2] != e.filler:
            length_wrong += 1
    return {
        "pcm_files_wrong": (pcm_wrong, 0),
        "status_files_wrong": (status_wrong, 0),
        "length_files_wrong": (length_wrong, 0),
        "checksum_passes_wrong": (sum(c != want_digest for c in checksums),
                                  0),
    }


def work(corpus: Corpus, exps) -> dict:
    """What one pass has to do, counted from the inputs."""
    samples = sum(e.n_good * e.block_len for e in exps)
    ops = sum(roofline.synth_ops(corpus.classes[f.cls].level,
                                 e.n_good * e.block_len)
              for f, e in zip(corpus.files, exps))
    return {"samples": samples, "payload_bytes": corpus.n_bytes,
            "synth_ops": ops}


def check(run, state: State) -> None:
    dc, perm = state.last
    rows, results = outputs(dc, perm)
    state.last = dc = None
    exps = expect.expected(state.corpus, run.devices[0])
    run.checks = compare(exps, rows, results,
                         [p["checksum"] for p in state.passes])
    w = work(state.corpus, exps)
    n = len(state.passes)
    run.attempted = n * len(state.files)
    run.failed = run.checks["pcm_files_wrong"][0]
    run.record.update(passes=state.passes, work=w)
    run.e2e["decode_Msamples_per_s"] = (
        n * w["samples"] / sum(p["wall_s"] for p in state.passes) / 1e6)
