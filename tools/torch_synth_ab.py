#!/usr/bin/env python3
"""Time one checkout's CUDA synthesis kernel at the main path's shapes.

    python3 tools/torch_synth_ab.py [--root DIR] [--reps 20]

Imports `libacm_tpu_torch` from DIR (default: the checkout holding this
script), builds its kernel, holds it bit-equal to its plain version on
the same inputs, and prints the card (`nvidia-smi` name and power limit)
and one JSON line: per shape, the kernel's device time in ms (CUDA events
around `reps` launches queued behind a sleeping kernel, so that launch
overhead on the host is not counted) and the launches each call made.

To compare two versions of the kernel, unpack both checkouts on one
machine and run this script on each in turns within one session
(A, B, B, A): two sessions may land on different cards.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

#: (level, rows, files, blocks per file): the shapes decode_corpus_device
#: gives the kernel on the bench corpus mix, then those of the stream
#: windows, the whole-file stream, the dense route and the sharded corpus,
#: then blocks that fit one CTA per SM or no CTA at all
SHAPES = [(7, 16, 25, 320), (4, 40, 15, 1216), (10, 4, 10, 160),
          (0, 2048, 5, 416),
          (7, 16, 1, 2048), (7, 1, 1, 512), (0, 2048, 1, 64),
          (7, 1, 1, 4800), (0, 2048, 1, 400), (0, 2048, 2, 416),
          (0, 2048, 3, 416),
          (13, 2, 1, 4), (12, 4, 1, 4), (10, 16, 2, 8), (14, 1, 1, 4),
          (15, 16, 1, 3), (13, 2, 1, 264), (10, 16, 4, 64), (15, 16, 2, 16)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_synth_ab: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from libacm_tpu_torch.ops import synth_cuda, synth_torch

    if not pathlib.Path(synth_cuda.__file__).resolve().is_relative_to(root):
        print(f"torch_synth_ab: imported {synth_cuda.__file__}, not from "
              f"{root}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    print(smi)
    dev = torch.device("cuda", 0)
    out = []
    for level, rows, B, nb in SHAPES:
        rng = np.random.default_rng(level)
        cols = 1 << level
        k = torch.from_numpy(rng.integers(-2000, 2000, (B, nb, rows, cols))
                             .astype(np.int16)).to(dev)
        v = torch.from_numpy(rng.integers(0, 1 << 16, (B, nb))
                             .astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(-500, 500, (B, max(2 * cols - 2,
                                                               1)))
                             .astype(np.int32)).to(dev)

        def run():
            return synth_cuda.synth_pcm_batch(k, v, w, level=level,
                                              rows=rows)

        synth_cuda.reset_launches()
        got = run()
        launches = dict(synth_cuda.launches)
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        if not (torch.equal(got[0], want[0])
                and (not level or torch.equal(got[1], want[1]))):
            print(f"torch_synth_ab: kernel differs from plain at "
                  f"{level}/{rows}", file=sys.stderr)
            return 1
        run()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # about 50 ms of the card's clock
        a.record()
        for _ in range(args.reps):
            run()
        b.record()
        torch.cuda.synchronize()
        out.append({"shape": [level, rows, B, nb],
                    "ms": a.elapsed_time(b) / args.reps,
                    "launches": launches})
    print(json.dumps({"root": str(root), "card": smi, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
