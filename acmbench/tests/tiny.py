"""Tiny checkouts of the benchmark for its CPU tests: the same files, with
every configuration cut to a few short files and the segments mix slowed
to what the CPU's plain paths serve."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**32 + 1234567


def shrink(config: dict) -> dict:
    c = json.loads(json.dumps(config))
    per_class = {"speech": 3, "music": 2}
    for k in c["classes"]:
        k["files"] = per_class.get(k["tag"], 1) * (4 if c["files"] >= 4000
                                                   else 1)
        if isinstance(k["blocks"], int):
            k["blocks"] = max(4, k["blocks"] // 25)
        else:
            k["blocks"] = [3, 24]
            k["files"] = 6
    if "hostile" in c:
        c["hostile"]["files"] = 5
    c["pool_blocks"] = 8
    return c


#: the entries of the cells BENCHMARK.json leaves out for now
PENDING = json.loads((REPO / "acmbench" / "pending.json").read_text())


def checkout(dst: pathlib.Path) -> pathlib.Path:
    """A copy of BENCHMARK.json (with the pending cells of
    acmbench/pending.json) and acmbench/ under dst, cut to size."""
    shutil.copytree(REPO / "acmbench", dst / "acmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        b[key] += PENDING[key]
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    for f in (dst / "acmbench" / "configs").glob("*.json"):
        f.write_text(json.dumps(shrink(json.loads(f.read_text()))))
    seg = dst / "acmbench" / "traffic" / "segments.json"
    t = json.loads(seg.read_text())
    t.update(rate_per_s=40.0, warm_requests=8, max_frames=5000)
    seg.write_text(json.dumps(t))
    return dst


def rehearse(root: pathlib.Path, workload: str, seconds: float = 0.5,
             trace: int = 0, seed: int = SEED) -> dict:
    """acmbench/rehearse.py in a subprocess of the checkout at root, the
    program taken from the repository."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root),
                                                       str(REPO)]))
    r = subprocess.run(
        [sys.executable, str(root / "acmbench" / "rehearse.py"),
         "--workload", workload, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(trace)],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def spec(root: pathlib.Path, workload: str):
    """The cell's Spec from the checkout at root, in this process."""
    from acmbench.harness import bench

    return bench.load_spec(root, workload)
