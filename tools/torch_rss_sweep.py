#!/usr/bin/env python3
"""Many-file random-access memory sweep of the port.

    python3 tools/torch_rss_sweep.py [N_FILES] [--device cuda|cpu]

The counterpart of tools/rss_sweep.py. Synthesizes N_FILES (default
10,000) small files from a seed into a temporary directory, then reads a
segment of every file through `RandomAccessCorpus(max_cached_files=8)` on
the card in two passes — forward, then a shuffled revisit that reuses the
cached indexes — and holds the growth of the resident set (VmRSS, sampled
after each pass) and `torch.cuda.max_memory_allocated()` to their budgets:
the corpus wrapper must hold O(few files) on the host and O(one segment)
on the card, not O(corpus). Every read is also held to backend="host" on
the first hundred files.

Prints the card (`nvidia-smi` name and power limit) and one summary line;
exits 1 over budget and 2 without a card. `--device cpu` runs the sweep on
the CPU (say, at 500 files): the device budget then does not apply.
"""

from __future__ import annotations

import argparse
import pathlib
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

RSS_BUDGET_MB = 256.0  # few files + index LRU + allocator slack
DEVICE_BUDGET_MB = 64.0  # one segment's wire, k and PCM, and the cache
ROOT = pathlib.Path(__file__).resolve().parents[1]


def rss_mb() -> float:
    """CURRENT resident set (VmRSS), not ru_maxrss: the in-process corpus
    synthesis sets a lifetime peak that would mask all serving-phase
    growth. What the sweep bounds — LRU cache residency — is persistent,
    so current RSS sampled after each pass captures it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("n_files", nargs="?", type=int, default=10_000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_rss_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import RandomAccessCorpus

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0].strip())
    n = args.n_files
    with tempfile.TemporaryDirectory(prefix="torch_rss_sweep_") as tmp:
        files = [pathlib.Path(tmp) / f"f{i:05d}.acm" for i in range(n)]
        t0 = time.perf_counter()
        for i, f in enumerate(files):
            rng = np.random.default_rng(7000 + i)
            f.write_bytes(testing.speech_acm_bytes(
                rng, level=3 + i % 3, rows=8 + 4 * (i % 5), n_blocks=4,
                channels=1 + i % 2))
        corpus_mb = sum(f.stat().st_size for f in files) / 1e6
        print(f"corpus: {n} files, {corpus_mb:.1f} MB on disk "
              f"(synth {time.perf_counter() - t0:.1f} s)", file=sys.stderr)

        paths = [str(f) for f in files]
        rac = RandomAccessCorpus(paths, max_cached_files=8, device=dev)
        host = RandomAccessCorpus(paths, max_cached_files=8, backend="host")
        rac.read(0, 5, 30)  # the kernel's build and the context come first
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        base = rss_mb()
        t0 = time.perf_counter()
        order = list(range(n))
        for i in order:
            got = rac.read(i, 5, 30)
            if i < 100 and not np.array_equal(got, host.read(i, 5, 30)):
                print(f"torch_rss_sweep: file {i} differs from "
                      "backend='host'")
                return 1
        fwd_s = time.perf_counter() - t0
        rss_fwd = rss_mb()
        np.random.default_rng(0).shuffle(order)
        t0 = time.perf_counter()
        for i in order:
            rac.read(i, 5, 30)
        rev_s = time.perf_counter() - t0
        grew = max(rss_fwd, rss_mb()) - base
        dev_mb = (torch.cuda.max_memory_allocated(dev) / 1e6 if on_card
                  else None)
        ok = (grew <= RSS_BUDGET_MB and rac.cached_files <= 8
              and (dev_mb is None or dev_mb <= DEVICE_BUDGET_MB))
        print(f"torch_rss_sweep: device={dev} n={n} "
              f"corpus={corpus_mb:.1f}MB rss_base={base:.1f}MB "
              f"rss_growth={grew:.1f}MB (budget {RSS_BUDGET_MB:.0f}) "
              f"device_peak="
              + (f"{dev_mb:.1f}MB (budget {DEVICE_BUDGET_MB:.0f})"
                 if dev_mb is not None else "n/a")
              + f" cached_files={rac.cached_files} "
              f"indexes={len(rac._index_lru)} fwd={fwd_s:.1f}s "
              f"({n / fwd_s:.0f} reads/s) revisit={rev_s:.1f}s "
              f"({n / rev_s:.0f} reads/s) {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
