#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. card:    the card's name and power limit (nvidia-smi); build the CUDA
            synthesis kernels (nvcc, sm_90a) and the port's C++ scanner.
2. parity:  each kernel route against the plain torch version on the card,
            random inputs from a numpy seed, on the PARITY geometries;
            tolerance 0 (PCM and final carry bit-equal).
3. corpus:  decode_corpus_device(device="cuda") over the bench corpus mix
            (bench.py's counts, ~120 M samples) — launch counters reset just
            before and read just after — checked file by file against the
            port's decode_corpus_host (PCM, status, filler words), and its
            checksum() against the same masked sum taken on the host.
4. numbers: end-to-end Msamples/s (host clock around work that ends in
            torch.cuda.synchronize()), each kernel's time per bench
            geometry with CUDA events beside the plain version's time and
            the bound, its launch shape (shared memory per CTA, resident
            CTAs per SM), and one JSON line of kernels.

The last line is {"ok": true, "device": {...}}. Needs no network; imports
torch, numpy and libacm_tpu_torch only.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

#: published H100 SXM rates (NVIDIA data sheet / Hopper white paper): HBM3
#: bandwidth, and int32 ALU issue = 132 SMs x 64 INT32 lanes x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

#: bench.py's corpus mix: (tag, count, distinct files encoded, level, rows,
#: n_blocks, channels, rate, wavc, base_pwr, decay_cols)
MIX = [
    ("speech", 120, 3, 7, 16, 300, 1, 22050, False, 5, 4.0),
    ("music", 30, 2, 7, 16, 300, 2, 44100, False, 8, 24.0),
    ("lvl4", 15, 2, 4, 40, 1200, 1, 22050, False, 5, 4.0),
    ("lvl10", 10, 2, 10, 4, 150, 2, 44100, False, 5, 4.0),
    ("lvl0", 5, 2, 0, 2048, 400, 1, 22050, False, 5, 4.0),
    ("wavc", 5, 2, 7, 16, 300, 1, 22050, True, 5, 4.0),
]
N_HOSTILE = 5  # 3 bit-flipped + 2 truncated level-7 members, as bench.py

#: kernel parity geometries (level, rows, files, blocks per file): the
#: bench geometries, then the extremes, then the fused route's edges
#: (many files; nb below one tile; n % 8 != 0, where k is staged in
#: copies narrower than 16 bytes; spans of several tiles cut mid-file)
PARITY = [(7, 16, 3, 41), (4, 40, 2, 37), (10, 4, 2, 9), (0, 2048, 2, 5),
          (10, 1, 2, 6), (14, 1, 1, 4), (15, 16, 1, 3), (5, 33, 2, 7),
          (9, 3, 2, 6), (7, 16, 40, 13), (7, 16, 1, 3), (1, 3, 2, 9),
          (2, 3, 3, 7), (7, 16, 100, 20), (4, 40, 200, 40)]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def make_corpus(testing, scale: float = 1.0, seed: int = 2026) -> list[bytes]:
    """The bench corpus mix, a few distinct encodes per class repeated up
    to the class count (scale < 1 shrinks counts and blocks, for a
    rehearsal on the CPU)."""
    rng = np.random.default_rng(seed)
    files: list[bytes] = []
    speech: list[bytes] = []
    for (tag, count, distinct, lv, rw, nb, ch, rate, wavc, pwr,
         decay) in MIX:
        nb = max(2, int(nb * scale))
        count = max(1, int(count * scale))
        enc = [testing.speech_acm_bytes(rng, level=lv, rows=rw, n_blocks=nb,
                                        channels=ch, rate=rate,
                                        base_pwr=pwr, decay_cols=decay,
                                        wavc=wavc)
               for _ in range(min(distinct, count))]
        if tag == "speech":
            speech = enc
        files += [enc[i % len(enc)] for i in range(count)]
    for i in range(N_HOSTILE):
        data = speech[i % len(speech)]
        if i < 3:
            b = bytearray(data)
            for _ in range(8):
                b[int(rng.integers(14, len(b)))] ^= 1 << int(rng.integers(0, 8))
            data = bytes(b)
        else:
            data = data[: int(len(data) * 0.7)]
        files.append(data)
    return files


def check_corpus(native, files, dc, host) -> int:
    """Device results ≡ host results per file; device checksum ≡ the same
    masked sum over the host decoder's committed blocks. Returns the
    number of files checked."""
    import torch

    from libacm_tpu_torch.ops import synth_torch

    got = dc.to_results()
    check(len(got) == len(host) == len(files), "result count mismatch")
    for g, h in zip(got, host):
        check(g.status == h.status,
              f"file {g.index}: status {g.status} != host {h.status}")
        check(g.filler_words == h.filler_words,
              f"file {g.index}: filler {g.filler_words} != {h.filler_words}")
        if h.pcm is None:
            check(g.pcm is None, f"file {g.index}: PCM where host has none")
        else:
            check(g.pcm is not None and np.array_equal(g.pcm, h.pcm),
                  f"file {g.index}: PCM differs from the host decode")
    want = 0
    for data, h in zip(files, host):
        if h.pcm is None:
            continue
        hd = native.decode_host(data)
        pcm = hd.pcm
        if hd.oor:
            # stale-amp-table stream: its result comes from the host
            # decoder, but the device slot (and so the checksum) holds the
            # k*val synthesis — take that on the host with the plain version
            scan = native.scan_bytes(data)
            pcm = synth_torch.synth_pcm_batch(
                torch.from_numpy(scan.k[None]),
                torch.from_numpy(scan.val.astype(np.int32)[None]),
                torch.zeros((1, max(2 * scan.header.cols - 2, 1)),
                            dtype=torch.int32),
                level=scan.header.level, rows=scan.header.rows)[0].numpy()
        want += int(pcm.astype(np.int64).sum())
    got_sum = dc.checksum()
    check(got_sum == want & 0xFFFFFFFF,
          f"checksum {got_sum} != host {want & 0xFFFFFFFF}")
    return len(files)


def bound(level: int, rows: int, B: int, nb: int) -> tuple[float, str]:
    """Least time (ms) for synthesis of [B, nb] blocks: k read and PCM
    written once (+ vals and carries) over HBM bandwidth, against the
    fewest int32 instructions the function needs over the int32 issue
    rate; returns (ms, what bounds it).

    Per sample: 1 to dequantize, 2 per FIR pass (y = 2m ± (a + c) is two
    three-input adds, the sign being fixed for each run of s samples),
    1 for the shift; plus the pass-0 bias on the 2/cols samples at
    f % s == 0."""
    cols = 1 << level
    samples = B * nb * rows * cols
    wbytes = 2 * B * (2 * cols - 2) * 4 if level else 0
    nbytes = 4 * samples + 4 * B * nb + wbytes
    ops = samples * (2 + 2 * level) + (samples * 2 // cols if level else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_breakdown(torch, corpus, files, card: str) -> None:
    """One decode under torch.profiler: device time by kernel name, the
    device's busy share of the wall time, and the host scan time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dc = corpus.decode_corpus_device(files, device="cuda")
        dc.block_until_ready()
        wall = time.perf_counter() - t0
    dev = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        dev.append((us / 1e3, ev.count, ev.key))
    busy = sum(ms for ms, _, _ in dev)
    if not busy:
        print("phase 4: profiler recorded no device time: breakdown not "
              "measured")
        return
    print(f"phase 4: profiled decode wall {wall * 1e3} ms, host scan "
          f"{dc.summary.scan_s * 1e3} ms, device busy {busy} ms "
          f"({busy / (wall * 1e3):.1%} of wall) {card}")
    ranked = sorted(dev, reverse=True)
    for i, (ms, count, key) in enumerate(ranked):
        if i < 8 or "synth_" in key:
            print(f"  device #{i + 1}: {ms} ms in {count} x {key[:90]}")


def _time_ms(torch, fn, reps: int) -> float:
    """Device time per call: CUDA events around `reps` calls queued behind
    a sleeping kernel, so that the card runs them back to back and the
    host's time to launch them is not counted."""
    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms of the card's clock
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _random_inputs(torch, dev, level, rows, B, nb, seed):
    rng = np.random.default_rng(seed)
    cols = 1 << level
    k = rng.integers(-2000, 2000, (B, nb, rows, cols)).astype(np.int16)
    v = rng.integers(0, 1 << 16, (B, nb)).astype(np.int32)
    w = rng.integers(-500, 500, (B, max(2 * cols - 2, 1))).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (k, v, w))


def _max_err(torch, got, want, level) -> int:
    err = int((got[0].to(torch.int32) - want[0].to(torch.int32))
              .abs().max().item()) if got[0].numel() else 0
    if level:
        err = max(err, int((got[1].to(torch.int64) - want[1].to(torch.int64))
                           .abs().max().item()))
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import synth_cuda, synth_torch
    from libacm_tpu_torch.parallel import corpus
    from libacm_tpu_torch.scan import native

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)

    # -- 1. card + builds ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    card = f"[{smi}]"
    print(smi)
    print(f"phase 1: torch device {name!r}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    scanner_ok: list[bool] = []
    th = threading.Thread(target=lambda: scanner_ok.append(native.available()))
    t0 = time.perf_counter()
    th.start()
    so, ptxas = synth_cuda.build()
    t_nvcc = time.perf_counter() - t0
    th.join()
    t_builds = time.perf_counter() - t0
    check(scanner_ok == [True], "the port's C++ scanner did not build")
    print(f"phase 1: built {so.name} (nvcc {t_nvcc:.1f} s) and the scanner "
          f"({t_builds:.1f} s for both)")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # -- 2. kernel parity ---------------------------------------------------
    parity_err = {"synth_fused": 0, "synth_pass": 0}
    parity_n = {"synth_fused": 0, "synth_pass": 0}
    for level, rows, B, nb in PARITY:
        k, v, w = _random_inputs(torch, dev, level, rows, B, nb,
                                 seed=level * 131 + rows)
        route = ("synth_fused" if synth_cuda.fused_tile(level, rows, nb)
                 else "synth_pass")
        got = synth_cuda.synth_pcm_batch(k, v, w, level=level, rows=rows)
        torch.cuda.synchronize()
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        err = _max_err(torch, got, want, level)
        parity_err[route] = max(parity_err[route], err)
        parity_n[route] += 1
        print(f"phase 2: {level}/{rows} B={B} nb={nb} {route}: max abs err "
              f"{err} (tolerance 0)")
        check(err == 0, f"kernel disagrees with plain at {level}/{rows}")
    check(all(parity_n.values()), "a kernel route was not exercised")

    # -- 3. main path at real size ------------------------------------------
    t0 = time.perf_counter()
    files = make_corpus(testing)
    print(f"phase 3: encoded {len(files)} files "
          f"({sum(map(len, files)) / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s")
    synth_cuda.reset_launches()
    t0 = time.perf_counter()
    dc = corpus.decode_corpus_device(files, device="cuda")
    dc.block_until_ready()
    t_first = time.perf_counter() - t0
    main_launches = dict(synth_cuda.launches)
    samples = dc.summary.samples
    shapes = sorted({(b.level, b.rows, b.pcm.shape[0], b.pcm.shape[1])
                     for b in dc._buckets})
    print(f"phase 3: decode_corpus_device: {samples} samples, "
          f"{len(dc._buckets)} chunks, launches {main_launches}, "
          f"first run {t_first:.3f} s {card}")
    for name_, n_ in main_launches.items():
        check(n_ > 0, f"main path launched {name_} no time")
    t0 = time.perf_counter()
    host = corpus.decode_corpus_host(files, workers=os.cpu_count() or 1)
    t_host = time.perf_counter() - t0
    print(f"phase 3: decode_corpus_host ({os.cpu_count()} threads) "
          f"{samples / t_host / 1e6} Msamples/s (host clock)")
    n_checked = check_corpus(native, files, dc, host)
    print(f"phase 3: {n_checked} files equal to decode_corpus_host; "
          f"checksum {dc.checksum():#010x} equal to the host sum")
    del dc

    # -- 4. numbers ---------------------------------------------------------
    runs, scans = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dcr = corpus.decode_corpus_device(files, device="cuda")
        dcr.block_until_ready()
        runs.append(time.perf_counter() - t0)
        scans.append(dcr.summary.scan_s)
        del dcr
    e2e = [samples / t / 1e6 for t in runs]
    print(f"phase 4: end-to-end device corpus decode {samples} samples: "
          f"runs {e2e} Msamples/s, median {statistics.median(e2e)} "
          f"Msamples/s; wall {runs} s, host scan {scans} s {card}")
    profile_breakdown(torch, corpus, files, card)

    per_geom = {}
    for level, rows, B, nb in shapes:
        if (level, rows) in per_geom and per_geom[(level, rows)][0] >= B:
            continue
        per_geom[(level, rows)] = (B, nb)
    kern_rows = {}
    # the JSON row of a route is its main-path shape with the most samples
    for (level, rows), (B, nb) in sorted(
            per_geom.items(), key=lambda g: -g[1][0] * g[1][1] * (
                g[0][1] << g[0][0])):
        k, v, w = _random_inputs(torch, dev, level, rows, B, nb, seed=level)
        route = ("synth_fused" if synth_cuda.fused_tile(level, rows, nb)
                 else "synth_pass")
        got = synth_cuda.synth_pcm_batch(k, v, w, level=level, rows=rows)
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        err = _max_err(torch, got, want, level)
        check(err == 0, f"kernel disagrees at main-path shape {level}/{rows}")
        del got, want
        ms = _time_ms(torch, lambda: synth_cuda.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=20)
        plain_ms = _time_ms(torch, lambda: synth_torch.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=5)
        bms, by = bound(level, rows, B, nb)
        cfg = synth_cuda.fused_config(level, rows, B, nb, dev) or {
            "smem_bytes": 0, "ctas_per_sm": synth_cuda.ctas_per_sm(
                route, 0, dev)}
        print(f"phase 4: launch {level}/{rows} [B={B}, nb={nb}] {route}: "
              f"{cfg['smem_bytes']} B shared memory per CTA, "
              f"{cfg['ctas_per_sm']} resident CTAs per SM"
              + (f", tile {cfg['T']} blocks, span {cfg['span']} blocks, "
                 f"grid {cfg['grid']}, {cfg['threads']} threads"
                 if "T" in cfg else ""))
        print(f"phase 4: synthesis {level}/{rows} [B={B}, nb={nb}] "
              f"{route}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}), {bms / ms:.1%} of bound "
              f"{card}")
        kern_rows.setdefault(route, {
            "name": route, "route": "cuda",
            "source": "libacm_tpu_torch/csrc/synth.cu",
            "replaces": "libacm_tpu/ops/synth_pallas.py:72",
            "launches": main_launches[route],
            "max_abs_err": max(err, parity_err[route]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "smem_bytes": cfg["smem_bytes"],
            "ctas_per_sm": cfg["ctas_per_sm"],
            "shape": f"level {level}, rows {rows}, B {B}, nb {nb}",
            "parity": f"bit-equal on {parity_n[route]} geometries",
        })
        del k, v, w
    check(set(kern_rows) == set(main_launches),
          "a kernel route has no main-path shape to time")
    print(json.dumps({"kernels": [kern_rows[r] for r in sorted(kern_rows)]}))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
