"""One run of one benchmark cell of libacm_tpu_torch on NVIDIA cards.

    python acmbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Loads the cell named in BENCHMARK.json
(its configuration, traffic mix and per-layer metrics, each from files of
its own: acmbench/harness/bench.py), makes its data from --seed, warms up,
measures for --seconds, checks what the timed path produced against the
plain reference (acmbench/reference), and prints one JSON line as the last
line of standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

With --trace 0 the metrics are the cell's end-to-end metrics; with
--trace 1 the window runs under torch.profiler and the metrics are its
per-layer ones, with the device's busy and window seconds and the trace's
breakdown. "checks" comes last: each number compared, beside its limit;
the same lines end standard error.

Exits non-zero and prints no result where CUDA is missing or has fewer
cards than the cell asks for, where the program is missing, and where the
process has loaded JAX or the JAX package by the time the window closed.
The program's build caches live in one fixed directory of the checkout,
.acmbench_cache/ (LIBACM_TPU_TORCH_CACHE): only the first run there
compiles.
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
CACHE_DIR = ROOT / ".acmbench_cache"


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"acmbench: {msg}", file=sys.stderr, flush=True)
    return code


def loaded_forbidden(forbidden) -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & forbidden)


def result_line(run, bench) -> dict:
    import torch

    line = {
        "correct": bench.correct(run),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": bench.metrics(run),
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(run.devices[0]),
            "count": len(run.devices),
            "memory_peak_bytes": run.memory_peak_bytes,
        },
    }
    summary = run.tracer.summary
    if run.trace and summary is not None and summary.complete:
        line["device"]["busy_s"] = summary.mean_busy_s()
        line["device"]["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.device_ops(),
                             "idle_gaps": summary.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in run.checks.items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["LIBACM_TPU_TORCH_CACHE"] = str(CACHE_DIR)
    sys.path.insert(0, str(ROOT))
    from acmbench.harness import bench

    try:
        spec = bench.load_spec(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        return fail(2, f"cannot load workload {args.workload!r}: {exc}")
    import torch

    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available():
        return fail(3, "CUDA is not available: this benchmark runs on the "
                       "card only")
    if torch.cuda.device_count() < chips:
        return fail(3, f"{args.workload} needs {chips} cards, "
                       f"{torch.cuda.device_count()} present")
    try:
        import libacm_tpu_torch  # noqa: F401
    except ImportError as exc:
        return fail(4, f"the program (libacm_tpu_torch) is missing: {exc}")
    from libacm_tpu_torch.ops import kernels

    kernels.build_all()
    devices = ([torch.device("cuda")] if chips == 1 else
               [torch.device("cuda", i) for i in range(chips)])
    run = bench.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                         devices, T_START)
    bad = loaded_forbidden(bench.FORBIDDEN_MODULES)
    if bad:
        return fail(5, f"the run loaded {', '.join(bad)}")
    line = result_line(run, bench)
    for k, v in run.record.items():
        if k in ("passes", "work", "requests", "tracks", "wall_s", "window",
                 "errors"):
            print(f"record {k}: {json.dumps(v)}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
