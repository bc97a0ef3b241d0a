#!/usr/bin/env python3
"""On-card parity sweep of the CUDA synthesis kernel: every level, every
route, with a zero and a non-zero carry-in, bit equality required; and of
the cols-wire unpack kernel at every level.

    python3 tools/torch_parity_sweep.py [--deadline-s=S] [LEVEL ...]

In the manner of tools/pallas_parity_sweep.py. For each level (default
0-15) the kernel wrapper runs on small batches on the card — rows near the
classic 2048-word block and rows == 1 (the fused route where a block fits
a CTA, level 0's kernel, and the wide passes and tail of blocks over 227
KB from level 13), and a split pair of launches whose second takes the
first's final carry on the device — and PCM and final carry are held
bit-equal to the plain torch version on the same tensors. The CPU tests
cover the plain version and a model of the kernel's schedule only; this
pins what nvcc built for every level the format allows.

For each level the unpack kernel (ops/unpack_cuda.py) also takes one
synthetic wire (bench_torch.synthetic_wire: random class map, widths and
payload; the wrap0 section on even levels) and is held bit-equal to its
plain version; its line starts with "unpack".

Prints the card (`nvidia-smi` name and power limit), one flushed line per
synthesis case (CASES_PER_LEVEL for each level) and per unpack case, and a
`SWEEP RESULT` line; exits 1
on a mismatch and 2 without a card. With --deadline-s the sweep stops
BETWEEN levels once S seconds have passed and reports `SWEEP RESULT:
PARTIAL ok=<levels>`, so that a caller with a time limit (bench_torch.py)
keeps the levels that were proved.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import time

import numpy as np

#: lines per level: two row shapes x two carries
CASES_PER_LEVEL = 4


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_parity_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import bench_torch
    from libacm_tpu_torch.ops import synth_cuda, synth_torch, unpack_cuda

    t_start = time.monotonic()
    deadline_s = None
    for a in [a for a in argv if a.startswith("--deadline-s=")]:
        deadline_s = float(a.split("=", 1)[1])
        argv = [x for x in argv if x != a]
    levels = [int(a) for a in argv] or list(range(16))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    failures = 0
    cases = 0
    routes = set()
    done: list[int] = []
    for level in levels:
        if deadline_s is not None and time.monotonic() - t_start > deadline_s:
            print(f"DEADLINE: stopping before level {level}", flush=True)
            break
        cols = 1 << level
        # odd levels get +1 so that rows vary in parity across the sweep
        base = max(2, min(64, 2048 // cols)) + (level % 2)
        for rows in (base, 1):
            B, nb = 2, 8
            k = torch.from_numpy(rng.integers(
                -300, 300, (B, nb, rows, cols)).astype(np.int16)).to(dev)
            vals = torch.from_numpy(rng.integers(
                1, 3000, (B, nb)).astype(np.int32)).to(dev)
            carry = torch.from_numpy(rng.integers(
                -10000, 10000, (B, 2 * cols - 2)).astype(np.int32)).to(dev)
            route = synth_cuda.route(level, rows, nb)
            routes.add(route)
            for what, wrap0 in (("zero carry", torch.zeros_like(carry)),
                                ("non-zero carry", carry)):
                got = synth_cuda.synth_pcm_batch(k, vals, wrap0, level=level,
                                                 rows=rows)
                want = synth_torch.synth_pcm_batch(k, vals, wrap0,
                                                   level=level, rows=rows)
                # two launches, the carry handed over on the card
                m = nb // 2 + 1
                a = synth_cuda.synth_pcm_batch(
                    k[:, :m].contiguous(), vals[:, :m].contiguous(), wrap0,
                    level=level, rows=rows)
                b = synth_cuda.synth_pcm_batch(
                    k[:, m:].contiguous(), vals[:, m:].contiguous(), a[1],
                    level=level, rows=rows)
                torch.cuda.synchronize()
                ok = (torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1])
                      and torch.equal(torch.cat([a[0], b[0]], dim=1),
                                      want[0])
                      and torch.equal(b[1], want[1]))
                print(f"level {level:2d} rows {rows:4d} {route:21s} "
                      f"{what:14s}: {'OK' if ok else 'MISMATCH'}",
                      flush=True)
                cases += 1
                failures += 0 if ok else 1
        wire = bench_torch.synthetic_wire(level, level, base, 2, 8,
                                          has_wrap=level % 2 == 0)
        kw = bench_torch.wire_args(wire)
        blob = torch.from_numpy(wire["blob"]).to(dev)
        got = unpack_cuda.unpack_cols_blob(blob, **kw)
        want = synth_torch.unpack_cols_blob_plain(blob, **kw)
        torch.cuda.synchronize()
        ok = bench_torch.unpack_max_err(torch, got, want) == 0
        print(f"unpack level {level:2d} rows {base:4d} "
              f"{'wrap0' if kw['has_wrap'] else 'no wrap0':8s}: "
              f"{'OK' if ok else 'MISMATCH'}", flush=True)
        cases += 1
        failures += 0 if ok else 1
        done.append(level)
    if failures:
        print(f"SWEEP RESULT: FAIL mismatch={failures} of {cases}")
        return 1
    if done != levels:
        print(f"SWEEP RESULT: PARTIAL ok={','.join(map(str, done))}")
        return 0
    print(f"SWEEP RESULT: PASS {cases} cases over levels "
          f"{levels[0]}-{levels[-1]}, routes {sorted(routes)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
