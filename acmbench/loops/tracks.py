"""Closed-loop whole-track reads on the reference API, one client: a player
or a transcoder writing WAV.

The client takes the tracks of the configuration's catalogue in seeded
uniform orders, each a permutation of the whole catalogue played before
the next (so every seed plays the same tracks, in another order), opens
each from its bytes (`acm_open_decoder(data,
device=...)`) and calls `read_loop(read_bytes)` until it returns nothing.
A track is timed from the open to its last byte. Set-up plays the
shortest and the longest track and two others. The window plays tracks
back to back until `--seconds` have passed.

Check: the first play of every track in the window against the plain
reference's PCM of the track, as acm_read_loop returns it, and every
later play of a track byte for byte against its first (compared between
tracks, outside their timing).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..gen.pool import Corpus, make_corpus
from ..harness import expect, stats

ORDER_STREAM = 6  # SeedSequence child of the seed for the play order


@dataclasses.dataclass
class State:
    corpus: Corpus
    datas: list
    order: np.random.Generator
    queue: list = dataclasses.field(default_factory=list)
    first: dict = dataclasses.field(default_factory=dict)
    latency_s: list = dataclasses.field(default_factory=list)
    played: list = dataclasses.field(default_factory=list)
    repeat_wrong: int = 0
    errors: int = 0


def play(run, data: bytes) -> tuple[bytes, float]:
    """One track from its bytes to its last byte: (PCM bytes, seconds)."""
    from libacm_tpu_torch import acm_open_decoder

    n = run.params["read_bytes"]
    chunks = []
    t0 = time.perf_counter()
    with run.tracer.span("track"):
        acm = acm_open_decoder(data, device=run.devices[0])
        while True:
            b = acm.read_loop(n)
            if not b:
                break
            chunks.append(b)
    dt = time.perf_counter() - t0
    acm.close()
    return b"".join(chunks), dt


def setup(run) -> State:
    corpus = make_corpus(run.spec.config, run.seed)
    datas = [f.data for f in corpus.files]
    rng = np.random.default_rng(
        np.random.SeedSequence(run.seed).spawn(ORDER_STREAM + 1)[-1])
    lengths = [len(f.ids) for f in corpus.files]
    for t in sorted({int(np.argmin(lengths)), int(np.argmax(lengths)),
                     0, len(datas) // 2}):
        play(run, datas[t])
    return State(corpus, datas, rng)


def window(run, state: State) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        if not state.queue:
            state.queue = state.order.permutation(len(state.datas)).tolist()
        t = state.queue.pop()
        try:
            out, dt = play(run, state.datas[t])
        except Exception:  # a failed track counts, and the client goes on
            state.errors += 1
            state.latency_s.append(float("inf"))
            state.played.append(t)
            continue
        state.latency_s.append(dt)
        state.played.append(t)
        if t not in state.first:
            state.first[t] = out
        elif out != state.first[t]:
            state.repeat_wrong += 1


def expected_bytes(e) -> bytes:
    """A track's PCM as acm_read_loop returns it: s16le, up to the CLI's
    stop."""
    return expect.exact_words(e)[: e.stop].astype("<i2").tobytes()


def compare(exps, first: dict) -> int:
    return sum(out != expected_bytes(exps[t]) for t, out in first.items())


def check(run, state: State) -> None:
    exps = expect.expected(state.corpus, run.devices[0])
    run.checks = {"tracks_wrong": (compare(exps, state.first)
                                   + state.repeat_wrong, 0),
                  "tracks_failed": (state.errors, 0)}
    lat = np.asarray(state.latency_s)
    lat[np.isinf(lat)] = run.seconds
    run.attempted = len(state.played)
    run.failed = state.errors
    run.e2e["track_p95_ms"] = stats.p95(lat) * 1e3
    run.record.update(tracks=len(state.played), window={
        "p50_ms": float(np.median(lat)) * 1e3,
        "p95_ms_by_quarter": [stats.p95(q) * 1e3
                              for q in np.array_split(lat, 4)]})
