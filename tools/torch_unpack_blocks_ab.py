#!/usr/bin/env python3
"""Time checkouts' CUDA block-unpack kernels on the same packed chunks, in
turns.

    python3 tools/torch_unpack_blocks_ab.py [--roots DIR ...] [--reps 20]

Builds the bench corpus mix from its seed (bench_torch.make_corpus),
scans it with the checkout holding this script, and packs three chunks as
the dense route without the scanner packs one (ops.packing.pack_blocks,
class counts padded to multiples of 64): the bench chunk (the first 25
speech files, 7/16, 7,500 blocks; bench_torch.packed_chunk), the 15
4/40 files, and 16 seeded 15/16 blocks of 524,288 words in all three
classes. Then, for each root in the order given (default: this
checkout), a fresh process imports `libacm_tpu_torch` from that root,
builds its block-unpack kernel, holds it bit-equal to that root's
unpack_blocks_plain on every chunk, and times it with this checkout's
timers: CUDA events over `reps` calls with the L2 warm and flushed
(bench_torch.time_ms, time_ms_cold), and the device operations and
device time of a call under the profiler, by kernel (bench_torch.profiled
over 10 calls).

To compare two commits, unpack the parent with `git archive` into a
directory .gitignore lists (`_ab/`) and give `--roots _ab . . _ab`: the
arms run in turns on one card.

Prints the card (`nvidia-smi` name and power limit), a line per arm and
chunk, and last one JSON line: per arm, per chunk, ms, cold_l2_ms, the
plain version's ms, device operations and device ms a call (and by
kernel), the bound (bench_torch.unpack_blocks_bound), and yardsticks of
the card's rate for like traffic in the same call: torch's zero fill of
the output (fill_ms, fill_TBps), its int8 -> int16 widening of the 8-bit
rows (widen_ms, widen_TBps: 3 bytes moved a word), and a copy_ of a
uint8 buffer that moves as many bytes as the bound counts (copy_ms,
copy_TBps).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
import tempfile
import types

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("p4", "p8", "p16", "idx4", "idx8", "idx16")


def _bench():
    spec = importlib.util.spec_from_file_location("bench_torch_timers",
                                                  HERE / "bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chunks(bench) -> dict:
    """{name: {nb, rows, cols, p4, ..., idx16}} of the three packed chunks,
    numpy arrays."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import packing
    from libacm_tpu_torch.scan import native

    files = bench.make_corpus(testing, 1.0, 2026)
    lvl4 = sum(m[1] for m in bench.MIX[:2])
    out = {"7/16 bench chunk": bench.packed_chunk(native, files),
           "4/40 chunk": bench.packed_chunk(native, files[lvl4:], 15)}
    rng = np.random.default_rng(1516)
    k = np.empty((16, 16, 1 << 15), np.int16)
    for i in range(len(k)):
        s = (8, 128, 32768)[i % 3]
        k[i] = rng.integers(-s, s, k.shape[1:])
    pads = tuple(-(-c // 64) * 64 for c in packing.class_counts(k))
    out["15/16 blocks"] = packing.pack_blocks(k, pad_to=pads)
    return {name: {"nb": pk.nb, "rows": pk.rows, "cols": pk.cols,
                   **{f: getattr(pk, f) for f in FIELDS}}
            for name, pk in out.items()}


def arm(root: pathlib.Path, chunks_file: str, reps: int) -> dict:
    """One root's kernel on the saved chunks: {chunk: row}."""
    import torch

    sys.path.insert(0, str(root))
    from libacm_tpu_torch.ops import packing, unpack_blocks_cuda

    mod = unpack_blocks_cuda
    if not pathlib.Path(mod.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    bench = _bench()
    _, report = mod.build()
    rows = {}
    for name, c in torch.load(chunks_file, weights_only=False).items():
        t = [torch.from_numpy(c[f]).to("cuda") for f in FIELDS]
        kw = {"nb": c["nb"], "rows": c["rows"], "cols": c["cols"]}
        got = packing.unpack_blocks(*t, **kw)
        want = packing.unpack_blocks_plain(*t, **kw)
        if not torch.equal(got, want):
            raise RuntimeError(f"{root}: kernel differs from plain on {name}")
        del got, want
        mod.reset_launches()
        packing.unpack_blocks(*t, **kw)
        launches = dict(mod.launches)
        ms = bench.time_ms(torch, lambda: packing.unpack_blocks(*t, **kw),
                           reps=reps)
        cold = bench.time_ms_cold(
            torch, lambda: packing.unpack_blocks(*t, **kw), reps=reps)
        plain = bench.time_ms(
            torch, lambda: packing.unpack_blocks_plain(*t, **kw), reps=reps)
        _, ranked = bench.profiled(
            torch, lambda: [packing.unpack_blocks(*t, **kw)
                            for _ in range(10)])
        bms, by = bench.unpack_blocks_bound(types.SimpleNamespace(**c))
        # the card's rates for like traffic in this call: torch's zero fill
        # of k (writes only), its int8 -> int16 widening of the 8-bit rows
        # (reads 1 byte and writes 2 a word, as the kernel does there), and
        # a copy_ that moves the bound's bytes (half read, half written)
        shape = (c["nb"], c["rows"], c["cols"])
        fill = bench.time_ms(torch, lambda: torch.zeros(
            shape, dtype=torch.int16, device="cuda"), reps=reps)
        widen = (bench.time_ms(torch, lambda: t[1].to(torch.int16),
                               reps=reps) if t[1].numel() else None)
        moved = int(bms * 1e-3 * bench.HBM_BYTES_PER_S) // 2
        src = torch.ones(moved, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        copy = bench.time_ms(torch, lambda: dst.copy_(src), reps=reps)
        del src, dst
        rows[name] = {"ms": ms, "cold_l2_ms": cold, "plain_ms": plain,
                      "call_ops": sum(ops for _, ops, _ in ranked) / 10,
                      "call_device_ms": sum(ms for ms, _, _ in ranked) / 10,
                      "call_by_name": [[kernel, ms / 10, ops / 10]
                                       for ms, ops, kernel in ranked],
                      "bound_ms": bms, "bound_by": by,
                      "fill_ms": fill,
                      "fill_TBps": 2 * np.prod(shape) / fill / 1e9,
                      "widen_ms": widen,
                      "widen_TBps": (3 * t[1].numel() / widen / 1e9
                                     if widen else None),
                      "copy_ms": copy, "copy_TBps": 2 * moved / copy / 1e9,
                      "launches_per_call": launches,
                      "packed_bytes": int(sum(c[f].nbytes for f in FIELDS)),
                      "blocks": c["nb"], "n": c["rows"] * c["cols"]}
    return {"root": str(root), "rows": rows,
            "ptxas": [ln for ln in report.splitlines() if "Used" in ln]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE)])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    ap.add_argument("--chunks", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_unpack_blocks_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.arm:
        print(json.dumps(arm(pathlib.Path(args.arm).resolve(), args.chunks,
                             args.reps)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    sys.path.insert(0, str(HERE))
    packed = chunks(_bench())
    arms = []
    with tempfile.TemporaryDirectory() as tmp:
        f = str(pathlib.Path(tmp) / "chunks.pt")
        torch.save(packed, f)
        for spec in args.roots:
            root = str(pathlib.Path(spec).resolve())
            cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
                   "--arm", root, "--chunks", f, "--reps", str(args.reps)]
            r = subprocess.run(cmd, capture_output=True, text=True,
                               cwd=root)
            if r.returncode:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            a = json.loads(r.stdout.strip().splitlines()[-1])
            arms.append(a)
            print(f"{spec} ptxas: {'; '.join(a['ptxas'])}")
            for name, row in a["rows"].items():
                print(f"{spec} {name} [{row['blocks']} x {row['n']}]: "
                      f"{row['ms']:.6f} ms ({row['cold_l2_ms']:.6f} flushed)"
                      f", {row['call_ops']} device operations "
                      f"({row['call_device_ms']:.6f} ms), plain "
                      f"{row['plain_ms']:.6f} ms, bound {row['bound_ms']:.6f}"
                      f" ({row['bound_by']}), "
                      f"{row['bound_ms'] / row['ms']:.1%}; fill "
                      f"{row['fill_ms']:.6f} ms ({row['fill_TBps']:.2f} TB/s)"
                      f", widen {row['widen_ms']} ms ({row['widen_TBps']} "
                      f"TB/s), copy {row['copy_ms']:.6f} ms "
                      f"({row['copy_TBps']:.2f} TB/s); "
                      + "; ".join(f"{n} {m:.6f} ms x {c:g}"
                                  for n, m, c in row["call_by_name"]))
    print(json.dumps({"card": card, "arms": arms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
