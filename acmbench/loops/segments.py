"""Open-loop segment reads: a segment server's traffic on one
`RandomAccessCorpus`.

Set-up writes the configuration's files under the run's temporary
directory (TMPDIR), opens one RandomAccessCorpus over their paths with a
persistent index directory beside them, and builds every file's index
there (a serving fleet builds them once). It then reads, one at a time,
every span length the traffic can ask of each geometry (`span_shapes`:
the program sizes its kernels' shared memory by span, and its first query
of a size is not safe against concurrent first queries of another), and
serves `warm_requests` requests on the workers. The window offers requests at a fixed Poisson rate
(`rate_per_s`) for `--seconds`, whatever the system does, to `workers`
threads that share the corpus (harness/schedule.py); each request is
timed from when it was due until its PCM array is in hand. A request
picks its file by Zipf(`zipf_s`) over the files of the kinds the mix
lists in `draw_kinds` (ranks in a seeded order), its start uniform in the
file and its length uniform from 1 to `max_frames` frames.
`max_cached_files` is handed to the corpus.

Check, once the window has closed: every answer of the window against the
plain reference's PCM of its file, sliced as read_segment clamps (to the
decodable end); a request that raised counts as wrong.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from ..gen.pool import Corpus, make_corpus
from ..harness import expect, stats
from ..harness.schedule import OpenLoopResult, poisson_arrivals, run_open_loop
from ..reference import decode as ref
from ..reference.format import resolve_channels

WARM_STREAM, WINDOW_STREAM = 4, 5  # SeedSequence children of the seed


@dataclasses.dataclass
class State:
    corpus: Corpus
    rac: object
    frames: np.ndarray
    channels: np.ndarray
    by_rank: np.ndarray
    requests: np.ndarray | None = None
    answers: list | None = None
    result: OpenLoopResult | None = None


def _rng(seed: int, child: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(seed).spawn(child + 1)[-1])


def draw(rng: np.random.Generator, state: State, params: dict,
         n: int) -> np.ndarray:
    """n requests as rows (file, start frame, frames)."""
    nf = len(state.by_rank)
    p = 1.0 / np.arange(1, nf + 1) ** params["zipf_s"]
    rank = np.minimum(np.searchsorted(np.cumsum(p / p.sum()),
                                      rng.random(n)), nf - 1)
    files = state.by_rank[rank]
    start = (rng.random(n) * state.frames[files]).astype(np.int64)
    length = rng.integers(1, params["max_frames"] + 1, n)
    return np.stack([files, start, length], axis=1)


def ranked(corpus: Corpus, params: dict, seed: int) -> np.ndarray:
    """The files a request may pick, most requested first (a seeded
    order)."""
    drawn = np.asarray([i for i, f in enumerate(corpus.files)
                        if f.kind in params["draw_kinds"]])
    return drawn[_rng(seed, 0).permutation(len(drawn))]


def span_shapes(state: State, params: dict) -> list[tuple[int, int, int]]:
    """Reads that give every span length the traffic can ask of every
    geometry drawn: for each geometry and channel count, from the start of
    a file, of 1 frame to max_frames in steps of 4 blocks."""
    out, seen = [], set()
    for f in state.by_rank.tolist():
        spec = state.corpus.classes[state.corpus.files[f].cls]
        key = (spec.level, spec.rows, int(state.channels[f]))
        if key in seen:
            continue
        seen.add(key)
        step = 4 * spec.block_len // int(state.channels[f])
        out += [(f, 0, n) for n in range(1, params["max_frames"] + 1, step)]
        out.append((f, 0, params["max_frames"]))
    return out


def _serve_all(run, state: State, reqs: np.ndarray, due: np.ndarray):
    answers: list = [None] * len(reqs)

    def serve(i: int) -> None:
        f, s, n = (int(x) for x in reqs[i])
        with run.tracer.span("read"):
            answers[i] = state.rac.read(f, s, n)

    return answers, run_open_loop(due, serve, run.params["workers"])


def setup(run) -> State:
    from libacm_tpu_torch.parallel import RandomAccessCorpus

    corpus = make_corpus(run.spec.config, run.seed)
    root = pathlib.Path(run.tmp)
    (root / "files").mkdir()
    paths = []
    frames, channels = [], []
    for i, f in enumerate(corpus.files):
        p = root / "files" / f"{i:05d}.acm"
        p.write_bytes(f.data)
        paths.append(str(p))
        h = ref.file_header(f.data)
        ch = resolve_channels(h.channels, h.wavc_file, 0)
        frames.append(h.total_values // ch)
        channels.append(ch)
    rac = RandomAccessCorpus(paths, index_dir=str(root / "index"),
                             max_cached_files=run.params["max_cached_files"],
                             device=run.devices[0])
    for i in range(len(paths)):
        rac.pcm_total(i)  # builds and stores the file's index
    state = State(corpus, rac, np.asarray(frames), np.asarray(channels),
                  ranked(corpus, run.params, run.seed))
    for f, s, n in span_shapes(state, run.params):
        rac.read(f, s, n)
    warm = draw(_rng(run.seed, WARM_STREAM), state, run.params,
                run.params["warm_requests"])
    _, res = _serve_all(run, state, warm, np.zeros(len(warm)))
    if res.failed:
        raise RuntimeError(f"{res.failed} warm-up reads failed: "
                           f"{next(e for e in res.errors if e)!r}")
    return state


def window(run, state: State) -> None:
    rng = _rng(run.seed, WINDOW_STREAM)
    due = poisson_arrivals(rng, run.params["rate_per_s"], run.seconds)
    state.requests = draw(rng, state, run.params, len(due))
    state.answers, state.result = _serve_all(run, state, state.requests,
                                             due)


def expected_answer(e: ref.Expected, exact: np.ndarray, start: int,
                    n: int) -> np.ndarray:
    """What read(file, start, n) returns: int16 [frames, channels],
    clamped to the decodable end."""
    ch = e.channels
    end = min(e.total_values, e.n_good * e.block_len)
    lo = start * ch
    hi = min(lo + n * ch, end)
    words = exact[lo:hi] if hi > lo else exact[:0]
    return words[: len(words) - len(words) % ch].reshape(-1, ch)


def compare(exps, requests: np.ndarray, answers: list) -> dict:
    exact: dict[int, np.ndarray] = {}
    wrong = 0
    for (f, s, n), got in zip(requests.tolist(), answers):
        if f not in exact:
            exact[f] = expect.exact_words(exps[f])
        want = expected_answer(exps[f], exact[f], s, n)
        if got is None or not np.array_equal(np.asarray(got), want):
            wrong += 1
    return {"segments_wrong": (wrong, 0)}


def check(run, state: State) -> None:
    res = state.result
    exps = expect.expected(state.corpus, run.devices[0])
    run.checks = compare(exps, state.requests, state.answers)
    run.checks["segments_failed"] = (res.failed, 0)
    lat = res.latency_s.copy()
    lat[[e is not None for e in res.errors]] = np.inf
    lat = np.where(np.isinf(lat), max(run.seconds, res.wall_s), lat)
    run.attempted = len(state.requests)
    run.failed = res.failed
    run.e2e["segment_p95_ms"] = stats.p95(lat) * 1e3
    thirds = np.array_split(res.latency_s, 3)
    errors = [f"{r.tolist()}: {e!r}" for r, e in
              zip(state.requests, res.errors) if e is not None]
    run.record.update(requests=len(state.requests), wall_s=res.wall_s,
                      errors=errors[:5],
                      window={"p50_ms": float(np.median(lat)) * 1e3,
                              "p95_ms_by_third": [stats.p95(t) * 1e3
                                                  for t in thirds],
                              "late_ms_max": float(res.late_s.max()) * 1e3})
