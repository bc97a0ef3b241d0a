#!/usr/bin/env python3
"""Probe what bounds the fused CUDA synthesis kernel on the card.

    python3 tools/torch_synth_probe.py [--out DIR]

Drives `synth_fused_kernel` through its C entry, holding every result
bit-equal to the plain version, and prints one JSON line per probe:

- levels: the kernel's time at a constant 16,384,000 samples (25 files of
  320 blocks of 2048 samples) for levels 3 to 10, with the wrapper's own
  launch plan. The slope over level is the cost of a pass; what is left
  at level 0 of the fit is the cost of moving k and PCM.
- tiles: 7/16 at the main path's shape with the tile forced to 1..6
  blocks (span as planned): the cost of a tile's barriers and its edges.
- spans: 7/16 with 5, 10, 20 and 40 spans per file: how far from one
  wave the grid may go.
- threads: 7/16 as planned, with 64 threads per CTA up to the kernel's
  own count (at most 512): how
  the cost of a pass depends on the length of each thread's runs.
- phases: the kernel built again with -DSYNTH_PROFILE, one launch at each
  main-path fused shape; per phase, thread 0's clock64() cycles averaged
  over the CTAs, and their share of the CTA's whole time.

Times are CUDA events around 20 launches queued behind a sleeping kernel.
With --out, the kernel's SASS (cuobjdump) is written to DIR/synth.sass.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


#: slots of synth_prof (csrc/synth.cu, SYNTH_PROFILE)
PHASES = ["cp.async wait", "tile barrier", "pass 0", "pass 0 barrier",
          "halo loads", "halo barriers", "walks", "walk barriers",
          "last pass"]


def phases(sc, dev, inputs) -> list[dict]:
    """Thread 0's cycles per phase, averaged over CTAs, at each fused
    main-path shape, from a build of the kernel with -DSYNTH_PROFILE."""
    import torch

    so = sc.build_dir() / "synth-profile.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([sc._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-DSYNTH_PROFILE", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(sc._SRC)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.acm_synth_fused.restype = ci
    lib.acm_synth_fused.argtypes = [vp] * 5 + [ci] * 8 + [ctypes.c_longlong,
                                                           vp]
    lib.acm_synth_prof_take.restype = ci
    lib.acm_synth_prof_take.argtypes = [vp]
    lib.acm_synth_attributes.restype = ci
    lib.acm_synth_attributes.argtypes = [ctypes.c_longlong] * 2
    sc.attributes(lib, dev)
    trace = np.zeros((4096, 16), dtype=np.int64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = []
    for level, rows, B, nb in [(7, 16, 25, 320), (4, 40, 15, 1216),
                               (10, 4, 10, 160)]:
        k, v, w = inputs(level, rows, B, nb)
        cfg = sc.fused_config(level, rows, B, nb, dev)
        pcm = torch.empty((B, nb, rows << level), dtype=torch.int16,
                          device=dev)
        wf = torch.empty_like(w)
        for _ in range(2):  # a warm-up launch, then the traced one
            lib.acm_synth_prof_take(trace.ctypes.data)
            rc = lib.acm_synth_fused(k.data_ptr(), v.data_ptr(),
                                     w.data_ptr(), pcm.data_ptr(),
                                     wf.data_ptr(), B, nb, level, rows,
                                     cfg["T"], cfg["span"],
                                     sc.synth_torch.warmup_blocks(level,
                                                                  rows),
                                     sc._FUSED_THREADS, cfg["smem_bytes"],
                                     stream)
            if rc:
                raise RuntimeError(f"profiled launch failed: cudaError {rc}")
            torch.cuda.synchronize()
        if lib.acm_synth_prof_take(trace.ctypes.data):
            raise RuntimeError("reading the phase trace failed")
        rows_ = trace[: cfg["grid"][0] * cfg["grid"][1]]
        total = rows_[:, 9].mean()
        out.append({"shape": [level, rows, B, nb],
                    "cycles_per_cta": total,
                    "tiles_per_cta": rows_[:, 10].mean(),
                    "phases": {name: [rows_[:, i].mean(),
                                      rows_[:, i].mean() / total]
                               for i, name in enumerate(PHASES)}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_synth_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from libacm_tpu_torch.ops import synth_cuda as sc
    from libacm_tpu_torch.ops import synth_torch as st

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    print(smi)
    dev = torch.device("cuda", 0)
    lib = sc._load()
    sc.attributes(lib, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def inputs(level, rows, B, nb):
        rng = np.random.default_rng(level)
        cols = 1 << level
        return (torch.from_numpy(rng.integers(-2000, 2000,
                                              (B, nb, rows, cols))
                                 .astype(np.int16)).to(dev),
                torch.from_numpy(rng.integers(0, 1 << 16, (B, nb))
                                 .astype(np.int32)).to(dev),
                torch.from_numpy(rng.integers(-500, 500, (B, 2 * cols - 2))
                                 .astype(np.int32)).to(dev))

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.reps

    def launch(k, v, w, level, rows, T, span, threads=sc._FUSED_THREADS):
        B, nb = k.shape[:2]
        n = rows << level
        pcm = torch.empty((B, nb, n), dtype=torch.int16, device=dev)
        wf = torch.empty_like(w)
        smem = sc.fused_smem_bytes(level, rows, T)

        def run():
            rc = lib.acm_synth_fused(k.data_ptr(), v.data_ptr(), w.data_ptr(),
                                     pcm.data_ptr(), wf.data_ptr(), B, nb,
                                     level, rows, T, span,
                                     sc.synth_torch.warmup_blocks(level,
                                                                  rows),
                                     threads, smem, stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")

        run()
        torch.cuda.synchronize()
        want = st.synth_pcm_batch(k, v, w, level=level, rows=rows)
        if not (torch.equal(pcm, want[0]) and torch.equal(wf, want[1])):
            raise RuntimeError(f"{level}/{rows} T={T} span={span} differs "
                               f"from plain")
        return timed(run)

    B, nb = 25, 320
    levels = []
    for level in range(3, 11):
        rows = 2048 >> level
        k, v, w = inputs(level, rows, B, nb)
        cfg = sc.fused_config(level, rows, B, nb, dev)
        ms = launch(k, v, w, level, rows, cfg["T"], cfg["span"])
        levels.append({"level": level, "rows": rows, "ms": ms,
                       "T": cfg["T"], "span": cfg["span"]})
    fit = np.polyfit([r["level"] for r in levels],
                     [r["ms"] for r in levels], 1)
    print(json.dumps({"probe": "levels", "card": smi, "B": B, "nb": nb,
                      "rows": levels, "ms_per_pass": fit[0],
                      "ms_at_level_0": fit[1]}))

    k, v, w = inputs(7, 16, B, nb)
    cfg = sc.fused_config(7, 16, B, nb, dev)
    tiles = [{"T": T, "ms": launch(k, v, w, 7, 16, T, cfg["span"])}
             for T in range(1, cfg["T"] + 1)]
    print(json.dumps({"probe": "tiles", "card": smi, "span": cfg["span"],
                      "rows": tiles}))
    spans = []
    for per_file in (5, 10, 20, 40):
        span = -(-nb // per_file)
        T = min(cfg["T"], span + 1)
        spans.append({"spans_per_file": per_file, "span": span, "T": T,
                      "ctas": B * -(-nb // span),
                      "ms": launch(k, v, w, 7, 16, T, span)})
    print(json.dumps({"probe": "spans", "card": smi, "rows": spans}))
    threads = [{"threads": nt, "ms": launch(k, v, w, 7, 16, cfg["T"],
                                            cfg["span"], nt)}
               for nt in (64, 128, 256, 512) if nt <= sc._FUSED_THREADS]
    print(json.dumps({"probe": "threads", "card": smi, "T": cfg["T"],
                      "rows": threads}))

    print(json.dumps({"probe": "phases", "card": smi,
                      "rows": phases(sc, dev, inputs)}))

    if args.out:
        so, _ = sc.build()
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                           text=True, timeout=120)
        (out / "synth.sass").write_text(r.stdout + r.stderr)
        print(f"SASS written to {out / 'synth.sass'} ({len(r.stdout)} "
              f"bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
