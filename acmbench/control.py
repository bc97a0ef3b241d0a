"""The control of the benchmark's check: the plain reference computed in
float32 (its filterbank passes; the configuration states int32
arithmetic, bit-exact) put in the program's place, judged by the same
comparison as a run. It has to come out not correct.

    python acmbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--device cuda|cpu] [--seconds S]

Prints one JSON line per seed: {"workload", "seed", "checks", "correct"}.
For the segments cell the answers are those of the requests a window of
--seconds would offer; for the tracks cell, every track of the catalogue.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control_checks(spec, seed: int, device, seconds: float) -> dict:
    import numpy as np
    import torch

    from acmbench.gen.pool import make_corpus
    from acmbench.harness import expect
    from acmbench.harness.schedule import poisson_arrivals
    from acmbench.loops import ingest, segments, tracks

    corpus = make_corpus(spec.config, seed)
    exps = expect.expected(corpus, device)
    ctrl = expect.expected(corpus, device, dtype=torch.float32)
    loop = spec.traffic["loop"]
    if loop == "ingest":
        rows = {f: e.pcm for f, e in enumerate(ctrl)}
        results = {f: (e.status, e.stop, e.filler,
                       None if e.exact is None
                       else e.exact[: e.stop].cpu().numpy())
                   for f, e in enumerate(ctrl)}
        return ingest.compare(exps, rows, results, [expect.digest(ctrl)])
    if loop == "segments":
        st = segments.State(corpus, None, np.asarray(
            [e.total_values // e.channels for e in exps]), None,
            segments.ranked(corpus, spec.traffic, seed))
        rng = segments._rng(seed, segments.WINDOW_STREAM)
        due = poisson_arrivals(rng, spec.traffic["rate_per_s"], seconds)
        reqs = segments.draw(rng, st, spec.traffic, len(due))
        words = {}
        answers = []
        for f, s, n in reqs.tolist():
            if f not in words:
                words[f] = expect.exact_words(ctrl[f])
            answers.append(segments.expected_answer(ctrl[f], words[f], s, n))
        return segments.compare(exps, reqs, answers)
    if loop == "tracks":
        first = {t: tracks.expected_bytes(e) for t, e in enumerate(ctrl)}
        return {"tracks_wrong": (tracks.compare(exps, first), 0)}
    raise ValueError(f"no control for loop {loop!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from acmbench.harness import bench

    spec = bench.load_spec(ROOT, args.workload)
    for seed in args.seeds:
        checks = control_checks(spec, seed, args.device, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": {k: v for k, (v, _) in checks.items()},
                          "correct": all(v <= lim for v, lim in
                                         checks.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
