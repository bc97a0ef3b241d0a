"""A run of one cell on the CPU, for the benchmark's own tests: the program's
plain paths (LIBACM_TPU_TORCH_DEVICE=cpu), no card, at whatever size the
checkout's configuration files give.

    python acmbench/rehearse.py --workload <name> --seed <n> --seconds <s>
        [--trace 0|1]

Prints one JSON line: {"rehearsal": true, "correct", "checks", "read",
"modules"}: the check's numbers, the names of the per-layer metrics whose
reader found something (no value: a CPU run gives no device number), and
the top-level names of every module the process loaded. It is never the
benchmark's result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["LIBACM_TPU_TORCH_DEVICE"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import torch

    from acmbench.harness import bench

    spec = bench.load_spec(ROOT, args.workload)
    devices = [torch.device("cpu")] * int(spec.cell["chips"])
    run = bench.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                         devices, T_START)
    read = sorted(bench.metrics(run)) if run.trace else []
    print(json.dumps({
        "rehearsal": True, "correct": bench.correct(run),
        "checks": {k: v for k, (v, _) in run.checks.items()},
        "read": read,
        "modules": sorted({m.split(".")[0] for m in list(sys.modules)})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
