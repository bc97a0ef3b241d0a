#!/usr/bin/env python3
"""Time checkouts' CUDA cols-wire unpack kernels on the same wires, in turns.

    python3 tools/torch_unpack_ab.py [--roots DIR ...] [--reps 20]
                                     [--scale 1.0] [--set NAME=VALUE ...]

Builds the bench corpus mix and the long stream from their seeds
(bench_torch.make_corpus, long_stream), decodes them on the card with the
checkout holding this script and captures the wires its paths unpack
(bench_torch.capture_wires): every corpus chunk, the windows of the long
stream at W = 2048 and the segments of 40 seeded random-access windows.
bench_torch.unpack_shapes picks the rows' wires: the largest chunk of
each corpus geometry, a stream window, and 7/16 segments of 8 and 32
blocks. Then, for each root in the order given (default: this checkout),
a fresh process imports `libacm_tpu_torch` from that root, builds its
unpack kernel, holds it bit-equal to that root's plain version on every
wire, and times it with this checkout's timers (bench_torch.time_ms,
time_ms_cold: CUDA events over `reps` calls, L2 warm and flushed).

`--set NAME=VALUE` sets an integer attribute of the roots' ops.unpack_cuda
that has it (a tile-size knob, say) before the timings; a root written
`DIR@NAME=VALUE,NAME=VALUE` gets its own, so one root given twice with
different knobs compares them. To compare two commits, unpack
the parent with `git archive` into a directory .gitignore lists (`_ab/`)
and give `--roots _ab . . _ab`: the arms run in turns on one card.

Prints the card (`nvidia-smi` name and power limit), a line per arm and
shape, and last one JSON line: per arm, per shape, ms, cold_l2_ms, the
bound (bench_torch.unpack_bound) and the launches of one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]


def _bench():
    spec = importlib.util.spec_from_file_location("bench_torch_timers",
                                                  HERE / "bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(torch, bench, scale: float) -> list:
    """[(what, path, wire)] of bench.unpack_shapes, blobs on the CPU."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import (RandomAccessCorpus, build_index,
                                           corpus)

    files = bench.make_corpus(testing, scale, 2026)
    stream = bench.long_stream(testing, build_index, bench.STREAM_SEED,
                               max(64, int(bench.STREAM_BLOCKS * scale)),
                               bench.STREAM_DISTINCT)
    wires = {}
    with bench.capture_wires() as got:
        corpus.decode_corpus_device(files, device="cuda").block_until_ready()
    wires["corpus"] = got
    with bench.capture_wires() as got:
        corpus.decode_stream_device(stream, device="cuda",
                                    window_blocks=bench.STREAM_WINDOWS[0])
    wires[f"stream_window_{bench.STREAM_WINDOWS[0]}"] = got
    rac = RandomAccessCorpus(files, device="cuda")
    rng = np.random.default_rng(9)
    with bench.capture_wires() as got:
        for _ in range(40):
            i = int(rng.integers(0, len(files)))
            rac.read(i, int(rng.integers(0, max(rac.pcm_total(i), 1))),
                     int(rng.integers(1, 50_001)))
    wires["random_access"] = got
    torch.cuda.synchronize()
    out = []
    for what, path, w in bench.unpack_shapes(wires, bench.STREAM_WINDOWS[0]):
        out.append((what, path, dict(w, blob=w["blob"].cpu())))
    return out


def arm(root: pathlib.Path, wires_file: str, reps: int,
        knobs: dict[str, int]) -> dict:
    """One root's kernel on the saved wires: {shape: row}."""
    import torch

    sys.path.insert(0, str(root))
    from libacm_tpu_torch.ops import synth_torch, unpack_cuda

    if not pathlib.Path(unpack_cuda.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {unpack_cuda.__file__}, not from {root}")
    for name, value in knobs.items():
        if hasattr(unpack_cuda, name):
            setattr(unpack_cuda, name, value)
    bench = _bench()
    _, report = unpack_cuda.build()
    rows = {}
    for what, _, w in torch.load(wires_file, weights_only=False):
        blob = w["blob"].to("cuda")
        kw = bench.wire_args(w)
        err = bench.unpack_max_err(torch, unpack_cuda.unpack_cols_blob(
            blob, **kw), synth_torch.unpack_cols_blob_plain(blob, **kw))
        if err:
            raise RuntimeError(f"{root}: kernel differs from plain on "
                               f"{what}: max abs err {err}")
        unpack_cuda.reset_launches()
        unpack_cuda.unpack_cols_blob(blob, **kw)
        per_call = dict(unpack_cuda.launches)
        ms = bench.time_ms(torch, lambda: unpack_cuda.unpack_cols_blob(
            blob, **kw), reps=reps)
        cold = bench.time_ms_cold(torch, lambda: unpack_cuda.unpack_cols_blob(
            blob, **kw), reps=reps)
        bms, by = bench.unpack_bound(w)
        key = f"{what} {kw['level']}/{kw['rows']} [{kw['batch']}, {kw['nb']}]"
        rows[key] = {"ms": ms, "cold_l2_ms": cold, "bound_ms": bms,
                     "bound_by": by, "launches_per_call": per_call,
                     "wire_bytes": int(blob.numel())}
    return {"root": str(root), "knobs": knobs, "rows": rows,
            "ptxas": [ln for ln in report.splitlines() if "Used" in ln]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE)])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=V")
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    ap.add_argument("--wires", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    knobs = {k: int(v) for k, v in (s.split("=", 1) for s in args.set)}

    import torch

    if not torch.cuda.is_available():
        print("torch_unpack_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.arm:
        print(json.dumps(arm(pathlib.Path(args.arm).resolve(), args.wires,
                             args.reps, knobs)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    sys.path.insert(0, str(HERE))
    wires = capture(torch, _bench(), args.scale)
    arms = []
    with tempfile.TemporaryDirectory() as tmp:
        f = str(pathlib.Path(tmp) / "wires.pt")
        torch.save(wires, f)
        for spec in args.roots:
            root, _, own = spec.partition("@")
            root = str(pathlib.Path(root).resolve())
            sets = args.set + [s for s in own.split(",") if s]
            cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
                   "--arm", root, "--wires", f, "--reps", str(args.reps)]
            cmd += [x for s in sets for x in ("--set", s)]
            r = subprocess.run(cmd, capture_output=True, text=True,
                               cwd=root)
            if r.returncode:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            a = json.loads(r.stdout.strip().splitlines()[-1])
            arms.append(a)
            print(f"{spec} ptxas: {'; '.join(a['ptxas'])}")
            for key, row in a["rows"].items():
                print(f"{spec} {key}: {row['ms']:.6f} ms "
                      f"({row['cold_l2_ms']:.6f} flushed), bound "
                      f"{row['bound_ms']:.6f} ({row['bound_by']}), "
                      f"{row['bound_ms'] / row['ms']:.1%}; "
                      f"{row['launches_per_call']}")
    print(json.dumps({"card": card, "arms": arms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
