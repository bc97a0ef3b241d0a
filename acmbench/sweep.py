"""Find the highest request rate the segments cell sustains: one set-up, then
the cell's open loop at each rate in turn.

    python acmbench/sweep.py [--workload fallout-1000.segments] --seed <n>
        --rates R [R ...] [--seconds S] [--device cuda|cpu]

Prints one JSON line per rate: the offered and completed rate, p50 and p95
latency (ms), and the p95 of the first and the last third of the requests
with how late the workers picked them up: a backlog that grows shows as a
last third far above the first. The benchmark's own runs never run it;
the cell's `rate_per_s` is set from it once.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="fallout-1000.segments")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import os

    os.environ["LIBACM_TPU_TORCH_CACHE"] = str(ROOT / ".acmbench_cache")
    sys.path.insert(0, str(ROOT))
    import tempfile

    import numpy as np
    import torch

    from acmbench.harness import bench, stats
    from acmbench.harness.schedule import poisson_arrivals
    from acmbench.harness.trace import Tracer
    from acmbench.loops import segments

    spec = bench.load_spec(ROOT, args.workload)
    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory(prefix="acmbench-") as tmp:
        run = bench.Run(spec, args.seed, args.seconds, False, [dev], tmp)
        run.tracer = Tracer(False, [dev], tmp)
        t = time.perf_counter()
        state = segments.setup(run)
        print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
        rng = segments._rng(args.seed, segments.WINDOW_STREAM)
        for rate in args.rates:
            due = poisson_arrivals(rng, rate, args.seconds)
            reqs = segments.draw(rng, state, spec.traffic, len(due))
            _, res = segments._serve_all(run, state, reqs, due)
            lat = res.latency_s * 1e3
            third = max(1, len(lat) // 3)
            print(json.dumps({
                "rate_offered": rate, "requests": len(lat),
                "rate_done": len(lat) / res.wall_s,
                "p50_ms": float(np.median(lat)), "p95_ms": stats.p95(lat),
                "p95_first_third_ms": stats.p95(lat[:third]),
                "p95_last_third_ms": stats.p95(lat[-third:]),
                "late_last_third_ms": float(res.late_s[-third:].mean() * 1e3),
                "failed": res.failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
