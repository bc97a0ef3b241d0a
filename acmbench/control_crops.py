"""The control of the crops cells' check: the plain reference computed in
float32 (its filterbank passes; the configuration states int32
arithmetic, bit-exact) put in the program's place, judged by the same
comparison as a run (acmbench/loops/crops.py). It has to come out not
correct.

    python acmbench/control_crops.py --workload <name> --seeds <n> [<n> ...]
        [--device cuda|cpu] [--batches N]

Prints one JSON line per seed: {"workload", "seed", "batches", "checks",
"correct"}. The answers are those of the first N batches (default: the
mix's keep_batches) that a window of that seed draws: each kept whole, and
each folded. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control_checks(spec, seed: int, device, n_batches: int) -> dict:
    import numpy as np
    import torch

    from acmbench.gen.pool import make_corpus
    from acmbench.harness import expect
    from acmbench.loops import crops

    p = spec.traffic
    corpus = make_corpus(spec.config, seed)
    exps = expect.expected(corpus, device)
    ctrl = expect.expected(corpus, device, dtype=torch.float32)
    ch = exps[0].channels
    want = p["segment_frames"] * ch
    frames = np.asarray([e.total_values // e.channels for e in exps])
    batch = crops.batch_size(p, len(exps))
    draw = crops.batches(crops._rng(seed, crops.WINDOW_STREAM), frames,
                         batch, p["segment_frames"])
    draws = [next(draw) for _ in range(n_batches)]
    weight = crops.fold_weight(seed, batch * want, device)
    cflat, coffs, cends = crops.reference_flat(ctrl, want, device)
    kept = [crops.reference_crops(cflat, coffs, cends, f, s, want, ch)
            for f, s in draws[: p["keep_batches"]]]
    folds = crops.reference_folds(cflat, coffs, cends, draws, weight, want,
                                  ch)
    del cflat, ctrl
    flat, offs, ends = crops.reference_flat(exps, want, device)
    return crops.compare(flat, offs, ends, draws, kept, folds, set(),
                         weight, want, ch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from acmbench.harness import bench

    spec = bench.load_spec(ROOT, args.workload)
    n = args.batches or spec.traffic["keep_batches"]
    for seed in args.seeds:
        checks = control_checks(spec, seed, args.device, n)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "batches": n,
                          "checks": {k: v for k, (v, _) in checks.items()},
                          "correct": all(v <= lim for v, lim in
                                         checks.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
