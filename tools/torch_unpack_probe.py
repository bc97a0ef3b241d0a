#!/usr/bin/env python3
"""Where a column tile of the CUDA cols-wire unpack spends its cycles.

    python3 tools/torch_unpack_probe.py [--scale 1.0]

Builds csrc/unpack.cu again with -DUNPACK_PROFILE (thread 0 of each of the
first 4,096 column tiles writes the clock64() cycles of each step), binds
it in place of the kernel of ops/unpack_cuda.py for this process, and
runs it once on each wire of tools/torch_unpack_ab.py's capture (the
wires the corpus, the stream windows and random access give the
kernel). Prints the card (`nvidia-smi` name, power limit and SM clock),
then per wire the kernel's time with the trace off (bench_torch.time_ms)
and, per step, the median and the 90th percentile of the tiles' cycles:
ticket, codes (the class codes and their ranks), look-back, loads (the
widths on o0, the nibbles before o0 and their scans), spans, staging
(the table, the copies and the clamp fill), values (and their stores),
and the part of the loads spent waiting for a width tile's prefix.
Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

#: the slots of unpack_prof (csrc/unpack.cu, UNPACK_PROFILE)
STEPS = ("ticket", "codes", "look-back", "loads", "spans", "staging",
         "values")
#: the part of "loads" thread 0 spent waiting for family 0's width prefix
WAIT = 7


def build_profiled(uc) -> ctypes.CDLL:
    """The kernel built with -DUNPACK_PROFILE beside the others, bound as
    ops/unpack_cuda.py binds it, plus acm_unpack_prof_take."""
    from libacm_tpu_torch.ops import synth_cuda

    so = synth_cuda.build_dir() / "unpack-prof.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([synth_cuda._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-DUNPACK_PROFILE", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(so), str(uc._SRC)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.acm_unpack.restype = ci
    lib.acm_unpack.argtypes = [vp, ctypes.POINTER(ctypes.c_longlong), vp,
                               vp, vp, vp, ci, ci, vp]
    lib.acm_unpack_prof_take.restype = ci
    lib.acm_unpack_prof_take.argtypes = [vp]
    return lib


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_unpack_probe: no CUDA device", file=sys.stderr)
        return 2
    import bench_torch
    from torch_unpack_ab import capture

    from libacm_tpu_torch.ops import unpack_cuda as uc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    wires = capture(torch, bench_torch, args.scale)
    plain_lib = uc._load()
    prof_lib = build_profiled(uc)
    trace = np.zeros((4096, 8), dtype=np.int64)
    for what, _, w in wires:
        blob, kw = w["blob"].to("cuda"), bench_torch.wire_args(w)
        uc._lib = plain_lib
        ms = bench_torch.time_ms(torch, lambda: uc.unpack_cols_blob(
            blob, **kw), reps=20)
        uc._lib = prof_lib
        uc.unpack_cols_blob(blob, **kw)
        torch.cuda.synchronize()
        prof_lib.acm_unpack_prof_take(trace.ctypes.data)  # clears it
        uc.unpack_cols_blob(blob, **kw)
        torch.cuda.synchronize()
        if prof_lib.acm_unpack_prof_take(trace.ctypes.data):
            raise RuntimeError("could not read the phase trace")
        nct = min(uc.plan(**kw)["nct"], 4096)
        cyc = trace[:nct, : len(STEPS)]
        steps = ", ".join(
            f"{name} {int(np.median(cyc[:, i]))}/{int(np.percentile(cyc[:, i], 90))}"
            for i, name in enumerate(STEPS))
        wait = trace[:nct, WAIT]
        print(f"{what} {kw['level']}/{kw['rows']} [{kw['batch']}, "
              f"{kw['nb']}]: {ms:.6f} ms (trace off), {nct} tiles; cycles "
              f"a tile, median/p90: {steps}; total median "
              f"{int(np.median(cyc.sum(1)))}; of the loads, the width-prefix "
              f"wait {int(np.median(wait))}/{int(np.percentile(wait, 90))}")
    uc._lib = plain_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
