#!/usr/bin/env python3
"""End-to-end benchmark of the PyTorch/CUDA port on one NVIDIA card.

    python3 bench_torch.py [--device cuda|cpu] [--repeats N] [--scale S]
                           [--seed N]

The counterpart of bench.py for libacm_tpu_torch. Prints ONE JSON line:

  {"metric": "corpus_decode_Msamples_per_s", "value": N,
   "unit": "Msamples/s", "vs_baseline": N/<C reference single-core> or null,
   "headline_path": "device", "device": {...}, ...}

`value` is the median device corpus rate on the card: the bench corpus mix
(bench.py's counts: 190 files, ~119 M samples, built from a seed) through
decode_corpus_device(device="cuda") + checksum(), PCM left on the card.

What is measured, every compared pair IN TURNS within the one call (A, B,
B, A, ... after a warm-up; host clock around work that ends in a
synchronise; median, min and max of each arm and the median of the
per-turn ratios), because host-bound numbers differ between machines by a
third:

- corpus:  the device path (cols-wire) against decode_corpus_host with its
           default threads and with every core; the dense device route
           (pack=False) beside the cols-wire route;
- windows: decode_stream_device over one long 7/16 stream for each window
           size of STREAM_WINDOWS and the full-file call;
- stream:  whole files through acm_open_decoder + read_loop, the card
           against synth_backend="host";
- random access: seeded windows through RandomAccessCorpus, the card
           against backend="host";
- scan:    the native packed scan alone (time_native_scan);
- reference: the C reference's `acmtool -d -n -q` where it can be had
           (ensure_reference), else vs_baseline is null;
- h2d:     one pageable host-to-device copy rate (8 MiB, fresh content);
- kernel rows: the CUDA synthesis kernels at each geometry of the corpus
           at the main path's shapes, at the stream window's, and at
           EXTRA_KERNEL_SHAPES (the shapes the other paths give the level-0
           and rows == 1 routes, and blocks that fit one CTA per SM or no
           CTA), by CUDA events with the L2 cache warm and flushed, beside
           the bound (bound), the plain torch version and the launches on
           the path; device_compute_Msamples_per_s is the corpus rows'
           harmonic mean weighted by each geometry's share of the corpus.
           Then the CUDA unpack on the wires the paths gave it (captured
           by capture_wires in the counted runs: the largest chunk of each
           corpus geometry, a stream window, random-access segments of 8
           and 32 blocks), beside unpack_bound and its plain version (the
           eager torch ops). No single PyTorch call computes either
           function: library_ms is null.

Correctness rides along: every device round's checksum() equals the first,
the dense route's equals the cols-wire route's, every stream arm's PCM sum
and every random-access window equal the host route's, and the kernel
parity verdict comes from tools/torch_parity_sweep.py in a subprocess.

Device. The default is the card; without one the bench exits non-zero
before any measurement and prints no line. `--device cpu` is a rehearsal of
the control flow (tests, a machine without a card): the line then says
"rehearsal": true, its device platform is "cpu", and every field that names
the card (CARD_FIELDS) is null — a CPU number is never written under a
device metric's name; what the CPU device path took goes under
"rehearsal_cpu".

The line survives a killer: SIGTERM/SIGINT/SIGHUP and atexit flush the
artifact secured so far (it exists once the first pair is measured). The
bench budgets itself (LIBACM_TPU_TORCH_BENCH_BUDGET_S, default 600 s):
groups that no longer fit are left null and named in "budget_skipped". A
crash after the first secured artifact emits it with "crashed": "<type:
message>" and exits non-zero; a crash before it prints no line and exits
non-zero. Nothing is measured on the CPU in place of a card run that
failed.

bench.py's relay machinery (relay_probe, safe_probe, wait_for_relay, the
recovery loop, HEALTHY_MBPS) has no counterpart here: the card is local,
there is no link to wait for. Its in-call backend shootout
(measure_backend) has none either (see libacm_tpu_torch/parallel): the
kernel rows take its place.

Imports torch, numpy and libacm_tpu_torch only. chip_smoke.py takes
make_corpus, long_stream, `bound`, the kernel timer, the unpack's wires
(synthetic_wire, UNPACK_EDGES, capture_wires) and its bound from here: one
definition each.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

#: published H100 SXM rates (NVIDIA data sheet / Hopper white paper): HBM3
#: bandwidth, and the int32 ALU rate = 132 SMs x 64 INT32 lanes x 1.98 GHz
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

#: the long stream: blocks (7/16 mono: 41.9 M samples, 31.7 minutes at
#: 22,050 Hz), the distinct encoded blocks it is drawn from, its seed, and
#: the windows: one that divides the block count and one that does not
STREAM_BLOCKS = 20480
STREAM_DISTINCT = 800
STREAM_SEED = 6
STREAM_WINDOWS = (2048, 3000)
#: random-access windows at scale 1, of 1..SEGMENT_FRAMES frames each
N_SEGMENTS = 1000
SEGMENT_FRAMES = 50_000

#: kernel rows beyond the corpus chunks and the stream window: (what, the
#: bench path that gives the shape or None, level, rows, B, nb)
EXTRA_KERNEL_SHAPES = [
    ("whole-file stream", "stream_whole", 0, 2048, 1, 400),
    ("whole-file stream, rows == 1", None, 7, 1, 1, 4800),
    ("stream window, rows == 1", None, 7, 1, 1, 512),
    ("stream window, level 0", None, 0, 2048, 1, 64),
    ("dense route", None, 0, 2048, 2, 416),
    ("sharded corpus", None, 0, 2048, 3, 416),
    ("one CTA per SM", None, 13, 2, 1, 4),
    ("blocks over 227 KB", None, 14, 1, 1, 4),
    ("blocks over 227 KB", None, 15, 16, 1, 3),
]

#: case lines tools/torch_parity_sweep.py prints for each level
SWEEP_CASES_PER_LEVEL = 4

BUDGET_ENV = "LIBACM_TPU_TORCH_BENCH_BUDGET_S"
#: the C reference: a built acmtool, or a checkout of its sources
REF_BIN_ENV = "ACMTOOL_REF"
REF_SRC_ENV = "LIBACM_REFERENCE_SRC"

#: fields that name the card: null in a --device cpu rehearsal
CARD_FIELDS = (
    "value", "device_corpus_Msamples_per_s", "device_vs_host_ratio",
    "device_vs_host_all_threads_ratio", "device_dense_Msamples_per_s",
    "device_dense_vs_cols_ratio", "device_checksum",
    "device_checksums_equal", "stream_window_card_Msamples_per_s",
    "stream_whole_card_Msamples_per_s", "stream_whole_card_vs_host_ratio",
    "segments_card_per_s", "segments_card_vs_host_ratio",
    "h2d_pageable_GBps", "kernel_rows", "device_compute_Msamples_per_s",
    "device_launches", "parity_sweep",
)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# -- data from a seed ---------------------------------------------------------


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


def mix_class_firsts(files: list[bytes], scale: float = 1.0) -> list[bytes]:
    """The first file of each class of make_corpus(scale)'s list."""
    firsts = np.cumsum([0] + [max(1, int(m[1] * scale)) for m in MIX])
    return [files[i] for i in firsts[:-1]]


def long_stream(testing, build_index, seed: int, n_blocks: int,
                distinct: int, level: int = 7, rows: int = 16) -> bytes:
    """A seeded mono stream of n_blocks blocks without encoding them all.

    The fixture encoder writes about 400 blocks a second, so `distinct`
    + 1 blocks of the speech class are encoded once, cut apart at their
    bit offsets (build_index), and n_blocks of them drawn from the seed
    are joined bit by bit behind a fresh header. Blocks are
    self-contained in the format, so the stream is valid; every junction
    gives the filterbank another carry."""
    rng = np.random.default_rng(seed)
    base = testing.speech_acm_bytes(rng, level=level, rows=rows,
                                    n_blocks=distinct + 1, base_pwr=5,
                                    decay_cols=4.0)
    pos = build_index(base).bitpos
    if len(pos) != distinct + 1:
        raise RuntimeError("long_stream: the base stream did not scan")
    bits = np.unpackbits(np.frombuffer(base, np.uint8), bitorder="little")
    order = rng.integers(0, distinct, n_blocks)
    body = np.concatenate([bits[pos[i]:pos[i + 1]] for i in order])
    w = testing.BitWriter()
    testing.write_header(w, n_blocks * (rows << level), 1, 22050, level,
                         rows)
    return w.getvalue() + np.packbits(body, bitorder="little").tobytes()


def scaled_stream_shape(scale: float) -> tuple[int, int, tuple[int, ...]]:
    """(blocks, distinct encoded blocks, windows) of the long stream at
    `scale` (1.0: STREAM_BLOCKS, STREAM_DISTINCT, STREAM_WINDOWS)."""
    if scale >= 1.0:
        return STREAM_BLOCKS, STREAM_DISTINCT, STREAM_WINDOWS
    return (max(8, int(STREAM_BLOCKS * scale)),
            max(4, int(STREAM_DISTINCT * scale)),
            tuple(max(2, int(w * scale)) for w in STREAM_WINDOWS))


# -- the kernel's bound and timer ---------------------------------------------


def bound(level: int, rows: int, B: int, nb: int) -> tuple[float, str]:
    """Least time (ms) for synthesis of [B, nb] blocks: k read and PCM
    written once (+ vals and carries) over HBM bandwidth, against the
    fewest int32 instructions the function needs over the int32 ALU
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


def time_ms(torch, fn, reps: int) -> float:
    """Device time per call: CUDA events around `reps` calls queued behind
    a sleeping kernel, so that the card runs them back to back and the
    host's time to launch them is not counted. Inputs of up to 50 MB stay
    in the L2 cache from one call to the next."""
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


def time_ms_cold(torch, fn, reps: int) -> float:
    """Device time per call with the 50 MB L2 cache flushed before each:
    a read of 128 MiB (a read, so that the call does not pay for writing
    back the flush's own lines), then CUDA events around the call alone,
    all queued behind a sleeping kernel."""
    flush = torch.zeros(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for a, b in ev:
        flush.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def random_inputs(torch, dev, level, rows, B, nb, seed):
    """(k, vals, wrap0) of [B, nb] blocks from a numpy seed, on dev."""
    rng = np.random.default_rng(seed)
    cols = 1 << level
    k = rng.integers(-2000, 2000, (B, nb, rows, cols)).astype(np.int16)
    v = rng.integers(0, 1 << 16, (B, nb)).astype(np.int32)
    w = rng.integers(-500, 500, (B, max(2 * cols - 2, 1))).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (k, v, w))


def max_err(torch, got, want, level) -> int:
    """Largest absolute difference of (pcm, final carry) pairs."""
    err = int((got[0].to(torch.int32) - want[0].to(torch.int32))
              .abs().max().item()) if got[0].numel() else 0
    if level:
        err = max(err, int((got[1].to(torch.int64) - want[1].to(torch.int64))
                           .abs().max().item()))
    return err


def kernel_route(synth_cuda, level: int, rows: int, nb: int) -> str:
    """The kernels one call launches at this geometry, joined by '+'."""
    return synth_cuda.route(level, rows, nb)


def route_launches(synth_cuda, launches: dict, level: int, rows: int,
                   nb: int) -> int:
    """Launches of a geometry's route (all its kernels) in a counter
    dict."""
    return sum(launches[k] for k in synth_cuda.kernel_launches(level, rows,
                                                                 nb))


# -- the C reference ----------------------------------------------------------


def ensure_reference() -> pathlib.Path | None:
    """The C reference's acmtool: $ACMTOOL_REF when that names a file, else
    built with gcc from the sources $LIBACM_REFERENCE_SRC names; None where
    neither is there (vs_baseline is then null)."""
    ref = os.environ.get(REF_BIN_ENV)
    if ref and pathlib.Path(ref).is_file():
        return pathlib.Path(ref)
    src = os.environ.get(REF_SRC_ENV)
    if not src or not (pathlib.Path(src) / "acmtool.c").exists():
        return None
    src_dir = pathlib.Path(src)
    out = pathlib.Path(tempfile.mkdtemp(prefix="acmtool_ref_")) / "acmtool"
    try:
        subprocess.run(
            ["gcc", "-O2", "-o", str(out), "-I", str(src_dir),
             str(src_dir / "decode.c"), str(src_dir / "util.c"),
             str(src_dir / "acmtool.c")],
            check=True, capture_output=True,
        )
        return out
    except (OSError, subprocess.CalledProcessError):
        return None


def time_reference_once(ref: pathlib.Path, files: list[pathlib.Path]) -> float:
    """One timed `acmtool -d -n -q <files>` run (decode, no output — the
    reference's own benchmark mode). check is off: hostile corpus members
    make the tool print errors, not fail."""
    argv = [str(ref), "-d", "-n", "-q"] + [str(f) for f in files]
    t0 = time.perf_counter()
    subprocess.run(argv, check=False, capture_output=True)
    return time.perf_counter() - t0


# -- the one-line artifact ----------------------------------------------------

_ARTIFACT: dict | None = None
_EMITTED = False


def set_artifact(d: dict) -> None:
    global _ARTIFACT
    _ARTIFACT = d


def emit_artifact() -> None:
    """Print the one-JSON-line artifact exactly once (idempotent): the
    normal end of main, the atexit hook, and the signal guard all call
    this, and whichever fires first wins. Guard signals are blocked
    before the write so an external killer cannot land mid-print and
    leave a truncated line (the handler would see _EMITTED and no-op)."""
    global _EMITTED
    if _EMITTED or _ARTIFACT is None:
        return
    import signal

    guard = {signal.SIGTERM, signal.SIGINT, signal.SIGHUP}
    try:
        signal.pthread_sigmask(signal.SIG_BLOCK, guard)
    except (OSError, ValueError, AttributeError):
        guard = None  # non-main thread / no sigmask: best effort
    _EMITTED = True
    print(json.dumps(_ARTIFACT, allow_nan=False), flush=True)
    if guard is not None:
        try:
            # UNBLOCK after the line is out: a blocked mask is inherited
            # by child processes, and a pending guard signal should now
            # fire (the handler sees _EMITTED and just exits)
            signal.pthread_sigmask(signal.SIG_UNBLOCK, guard)
        except (OSError, ValueError):
            pass


def _install_artifact_guard() -> None:
    """The artifact must survive an EXTERNAL killer (a caller's timeout):
    SIGTERM/SIGINT/SIGHUP flush the best artifact secured so far, marked
    "interrupted", and exit 0; atexit covers unforeseen clean exits (only
    SIGKILL remains unguardable)."""
    import atexit
    import signal

    def _flush(signum, frame):
        # Async-signal context: bypass buffered stdio entirely (a print
        # here could re-enter a buffered write and raise; os.write is a
        # direct syscall). The normal emit path blocks these signals
        # around its own print, so _EMITTED is a reliable gate.
        global _EMITTED
        try:
            if not _EMITTED and _ARTIFACT is not None:
                _EMITTED = True
                line = dict(_ARTIFACT, interrupted=f"signal {signum}")
                os.write(1, (json.dumps(line, allow_nan=False)
                             + "\n").encode())
            os.write(2, f"signal {signum}: artifact guard exit\n".encode())
        except Exception:
            pass
        os._exit(0)

    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        try:
            signal.signal(sig, _flush)
        except (OSError, ValueError, AttributeError):
            pass
    atexit.register(emit_artifact)


def _ratio(num: float | None, den: float | None) -> float | None:
    return round(num / den, 3) if num and den else None


# -- arms in turns ------------------------------------------------------------


def turn_order(n_arms: int, repeats: int) -> list[list[int]]:
    """The arms' order in each round: forwards in even rounds, backwards
    in odd ones (two arms: A, B, B, A, A, B, ...), so that no arm always
    runs first or always follows the same neighbour."""
    fwd = list(range(n_arms))
    return [fwd if r % 2 == 0 else fwd[::-1] for r in range(repeats)]


def run_in_turns(arms, repeats: int, *, warmup: int = 1, sync=None,
                 on_result=None, deadline: float | None = None,
                 clock=time.perf_counter) -> dict[str, list[float]]:
    """Time `arms` ([(name, fn)]) in turns: `warmup` untimed rounds, then
    `repeats` rounds in turn_order. `sync` runs before the clock starts and
    before it stops; on_result(name, value) gets each call's value outside
    the timed region. Past `deadline` (time.time()) no new round starts
    once one is complete. Returns {name: [seconds of each round]}."""
    sync = sync or (lambda: None)
    times: dict[str, list[float]] = {name: [] for name, _ in arms}
    rounds = [list(range(len(arms)))] * warmup + turn_order(len(arms),
                                                            repeats)
    for r, order in enumerate(rounds):
        timed = r >= warmup
        if (timed and deadline is not None and time.time() > deadline
                and all(times.values())):
            log(f"  budget: stopping after {len(times[arms[0][0]])} rounds")
            break
        for i in order:
            name, fn = arms[i]
            sync()
            t0 = clock()
            value = fn()
            sync()
            dt = clock() - t0
            if timed:
                times[name].append(dt)
            if on_result is not None:
                on_result(name, value)
    return times


def summarize(seconds: list[float], work: float) -> dict:
    """Rates (work / seconds) of one arm: median, min, max and each run,
    unrounded."""
    rates = [work / t for t in seconds]
    return {"median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "runs": rates}


def turn_ratio(a_seconds: list[float], b_seconds: list[float]) -> float:
    """Median over the rounds of arm A's rate over arm B's in that round."""
    return statistics.median(b / a for a, b in zip(a_seconds, b_seconds))


# -- single measurements ------------------------------------------------------


def time_native_scan(datas: list[bytes], total: int) -> float | None:
    """Min-of-3 native packed scan of the whole corpus (pure host work),
    on the port's own scanner copy; Msamples/s."""
    from libacm_tpu_torch.scan import native

    if not native.available():
        return None
    best = min(_scan_once(native, datas) for _ in range(3))
    return total / best / 1e6


def _scan_once(native, datas) -> float:
    t0 = time.perf_counter()
    for d in datas:
        try:
            native.scan_bytes_packed(d)
        except ValueError:
            pass  # hostile member with a broken header
    return time.perf_counter() - t0


def h2d_pageable_gbps(torch, dev) -> float:
    """Median rate of an 8 MiB copy from pageable host memory to the card,
    fresh content each time (GB/s)."""
    rng = np.random.default_rng(np.frombuffer(os.urandom(8), np.uint64))
    rates = []
    for i in range(6):
        big = rng.integers(0, 255, size=8 << 20, dtype=np.uint8)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        d = torch.from_numpy(big).to(dev)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        del d
        if i:  # the first copy warms the path
            rates.append(big.nbytes / dt / 1e9)
    return statistics.median(rates)


def parity_sweep(timeout_s: float = 300.0, echo=None) -> str:
    """The on-card kernel-against-plain sweep in a subprocess
    (timeout-bounded): "PASS", "FAIL", "PARTIAL: ..." or an error string.

    The tool stops BETWEEN levels at its own deadline and prints a flushed
    `SWEEP RESULT:` line; if the hard subprocess timeout fires mid-level
    anyway, the per-case lines flushed so far are salvaged from the pipe
    into a PARTIAL verdict. rc != 0 with no mismatch in the output is a
    crash (no card, an import error, a failed build), never a FAIL: FAIL
    documents a bit mismatch that did happen."""
    sweep = ROOT / "tools" / "torch_parity_sweep.py"
    argv = [sys.executable, str(sweep),
            f"--deadline-s={max(30.0, timeout_s - 20.0)}"]
    timed_out = False
    try:
        r = subprocess.run(argv, timeout=timeout_s,
                           capture_output=True, text=True)
        out, rc = r.stdout or "", r.returncode
    except subprocess.TimeoutExpired as exc:
        out, rc, timed_out = exc.stdout or "", None, True
        if isinstance(out, bytes):
            out = out.decode("utf-8", errors="replace")
    for line in out.splitlines():
        (echo or log)("  " + line)
    result = next((ln for ln in out.splitlines()
                   if ln.startswith("SWEEP RESULT:")), "")
    if "FAIL" in result or ": MISMATCH" in out:
        return "FAIL"
    if result.startswith("SWEEP RESULT: PASS"):
        return "PASS"
    if result.startswith("SWEEP RESULT: PARTIAL"):
        return f"PARTIAL: levels {result.split('ok=', 1)[1]} OK (deadline)"
    # hard timeout mid-level: salvage the levels whose cases all printed
    n_ok: dict[str, int] = {}
    for ln in out.splitlines():
        if ln.startswith("level") and ln.rstrip().endswith(": OK"):
            n_ok[ln.split()[1]] = n_ok.get(ln.split()[1], 0) + 1
    oks = [lv for lv, n in n_ok.items() if n == SWEEP_CASES_PER_LEVEL]
    if oks:
        return f"PARTIAL: levels {','.join(oks)} OK (timed out mid-level)"
    if timed_out:
        return "sweep timed out"
    return f"error (sweep subprocess crashed, rc={rc})"


def _pcm_sum(pcm, n_words: int) -> int:
    """Sum of the first n_words int16 words of a decode_stream_device
    result (one tensor)."""
    import torch

    return int(pcm.reshape(-1)[:n_words].sum(dtype=torch.int64).item())


# -- the bench ----------------------------------------------------------------


def device_identity(torch, dev) -> dict:
    """What every result carries: the platform, the card's name and count
    as torch sees them, and nvidia-smi's name and power limit."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def kernel_rows(torch, dev, shapes, launches, card: str) -> list[dict]:
    """One row per (what, path, level, rows, B, nb) of `shapes`: the
    kernel held to its plain version (tolerance 0), its time by CUDA
    events over 20 launches (L2 warm, and flushed before each), the plain
    version's, the bound and the share of it, and its route's launches on
    the path that gives it the shape (path None: those of one call)."""
    from libacm_tpu_torch.ops import synth_cuda, synth_torch

    rows_out = []
    for what, path, level, rows, B, nb in shapes:
        k, v, w = random_inputs(torch, dev, level, rows, B, nb,
                                seed=level * 3 + nb)
        route = kernel_route(synth_cuda, level, rows, nb)
        got = synth_cuda.synth_pcm_batch(k, v, w, level=level, rows=rows)
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        err = max_err(torch, got, want, level)
        if err:
            raise RuntimeError(f"kernel disagrees with its plain version at "
                               f"{level}/{rows} [{B}, {nb}]: max abs err "
                               f"{err}")
        del got, want
        ms = time_ms(torch, lambda: synth_cuda.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=20)
        cold_ms = time_ms_cold(torch, lambda: synth_cuda.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=20)
        plain_ms = time_ms(torch, lambda: synth_torch.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=5)
        bms, by = bound(level, rows, B, nb)
        samples = B * nb * (rows << level)
        n_launch = route_launches(
            synth_cuda, launches[path] if path in launches
            else synth_cuda.kernel_launches(level, rows, nb), level, rows, nb)
        rows_out.append({
            "name": f"{route} ({what}, {level}/{rows} [{B}, {nb}])",
            "kernel": "synth",
            "route": "cuda", "source": "libacm_tpu_torch/csrc/synth.cu",
            "replaces": "libacm_tpu/ops/synth_pallas.py:72",
            "path": path if path in launches else "one call",
            "launches": n_launch,
            "max_abs_err": err, "ms": ms, "cold_l2_ms": cold_ms,
            "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
            "library_ms": None,
            "Msamples_per_s": samples / ms / 1e3,
            "level": level, "rows": rows, "B": B, "nb": nb,
        })
        log(f"  kernel {level}/{rows} [{B}, {nb}] {route}: {ms:.4f} ms "
            f"({cold_ms:.4f} with L2 flushed), plain {plain_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), {bms / ms:.1%} of bound {card}")
        del k, v, w
    return rows_out


# -- the unpack kernel: wires, bound, rows --------------------------------------


def synthetic_wire(seed: int, level: int, rows: int, batch: int, nb: int, *,
                   has_wrap: bool = True, cls=None, pay=(None, None, None),
                   wid=(None, None, None), wid_fill: int | None = None) -> dict:
    """A cols-wire blob from a numpy seed, with the keyword arguments of
    ops.synth_torch.unpack_cols_blob: {"blob": uint8 numpy, "level",
    "rows", "batch", "nb", "lens", "has_wrap"}. The class map is random
    (padding codes included) unless `cls` maps it to another; width and
    payload bytes are random (width bytes all `wid_fill` where given);
    each payload and width section has its natural length (the bits and
    nibbles its columns need) unless `pay` / `wid` give one."""
    from libacm_tpu_torch.parallel.corpus import _coalesce_wire

    rng = np.random.default_rng(seed)
    cols = 1 << level
    cm = rng.integers(0, 256, (batch, nb, (cols + 3) // 4), dtype=np.uint8)
    if cls is not None:
        cm = cls(cm)
    codes = ((cm[..., None] >> (np.arange(4) * 2)) & 3).reshape(
        batch, nb, -1)[..., :cols].reshape(-1)
    pays, wids = [], []
    for f in range(3):
        ncol = int((codes == f + 1).sum())
        wl = -(-ncol // 2) if wid[f] is None else wid[f]
        wb = (rng.integers(0, 256, wl, dtype=np.uint8) if wid_fill is None
              else np.full(wl, wid_fill, np.uint8))
        nibs = np.stack([wb & 15, wb >> 4], -1).reshape(-1)[:ncol]
        bits = rows * int((nibs.astype(np.int64) + 1).sum())
        pl = 2 * -(-bits // 16) if pay[f] is None else pay[f]
        pays.append(rng.integers(0, 256, pl, dtype=np.uint8))
        wids.append(wb)
    secs = [cm.reshape(-1)] + pays + wids
    secs.append(rng.integers(0, 1 << 16, batch * nb).astype(np.uint16))
    if has_wrap:
        secs.append(rng.integers(-(1 << 31), 1 << 31, batch * (2 * cols - 2),
                                 dtype=np.int64).astype(np.int32))
    blob, lens = _coalesce_wire(secs)
    return {"blob": blob.copy(), "level": level, "rows": rows,
            "batch": batch, "nb": nb, "lens": lens, "has_wrap": has_wrap}


def random_wire(seed: int) -> dict:
    """A synthetic_wire of a random geometry (level 0-15, up to 2^17
    samples a file) from a numpy seed, each payload and width section at
    its natural length, or (two in five) empty, one byte, or short."""
    rng = np.random.default_rng(seed)
    level = int(rng.integers(0, 16))
    rows = int(rng.choice([1, 2, 3, 16, 40, int(rng.integers(1, 300))]))
    cap = max(1, (1 << 17) // (rows << level))
    batch = int(rng.integers(1, 4))
    nb = int(rng.integers(1, min(cap, 200) + 1))

    def length(short):
        return None if rng.random() < 0.6 else short()

    pay = tuple(length(lambda: int(rng.choice(
        [0, 1, 2, 2 * int(rng.integers(1, 50))]))) for _ in range(3))
    wid = tuple(length(lambda: int(rng.integers(0, 9))) for _ in range(3))
    return synthetic_wire(seed, level, rows, batch, nb, pay=pay, wid=wid,
                          has_wrap=bool(rng.random() < 0.5))


def _zero_first_tile(cm):
    """A level-2 class map whose first 1,024 columns are all zero."""
    cm = cm.copy()
    cm.reshape(-1)[:256] = 0
    return cm


#: the unpack's edges that real wires rarely or never show: name ->
#: (seed, level, rows, batch, nb, synthetic_wire options)
UNPACK_EDGES = {
    "family absent (payload < 2 bytes)":
        (1, 4, 9, 2, 5, {"pay": (1, 0, None)}),
    "empty width stream": (2, 5, 7, 2, 4, {"wid": (None, 0, None)}),
    "width stream shorter than the ordinals (clamp)":
        (3, 5, 7, 2, 6, {"wid": (2, 1, 3)}),
    "payload shorter than the columns (clamped words)":
        (4, 4, 11, 2, 5, {"pay": (2, 6, 4)}),
    "16-bit values in the last word":
        (5, 3, 13, 2, 7, {"cls": lambda cm: cm | 0xFF, "wid_fill": 0xFF}),
    "sections at odd byte offsets":
        (6, 2, 5, 3, 5, {"wid": (3, 5, 7), "pay": (10, 14, 22)}),
    "padding codes at level 0": (7, 0, 33, 3, 11, {}),
    "padding codes at level 1": (8, 1, 17, 2, 9, {}),
    "rows == 1": (9, 6, 1, 2, 9, {}),
    "level 0, rows 2048": (10, 0, 2048, 2, 5, {}),
    "N not a multiple of a tile": (11, 3, 6, 3, 50, {}),
    "a tile with no non-zero column":
        (12, 2, 6, 1, 600, {"cls": _zero_first_tile}),
    "has_wrap false": (13, 7, 4, 2, 12, {"has_wrap": False}),
    "several tiles of several width tiles": (14, 10, 3, 2, 5, {}),
    "a span that ends at the stream's last word": (15, 5, 16, 2, 7, {}),
    "ordinals past 2L at a width-tile boundary":
        (16, 10, 2, 3, 3, {"wid": (1024, 1024, 3)}),
    "a 1-byte payload among many tiles":
        (17, 7, 16, 2, 40, {"pay": (None, 1, None)}),
    "a width stream of 40 tiles": (18, 7, 16, 2, 40,
                                   {"wid": (40000, None, None)}),
    "a width stream of 293 tiles": (20, 4, 3, 2, 5,
                                    {"wid": (300000, None, None)}),
}


def edge_wire(name: str) -> dict:
    """UNPACK_EDGES[name] as a synthetic_wire."""
    seed, level, rows, batch, nb, opts = UNPACK_EDGES[name]
    return synthetic_wire(seed, level, rows, batch, nb, **opts)


class capture_wires:
    """Within `with capture_wires() as wires:`, every call of
    ops.synth_torch.unpack_cols_blob (and so of synth_pcm_cols_blob) is
    recorded in `wires` as a dict: a copy of the blob on its device and
    the call's keyword arguments. The call itself runs as before."""

    def __enter__(self) -> list[dict]:
        from libacm_tpu_torch.ops import synth_torch

        self._mod, self._real = synth_torch, synth_torch.unpack_cols_blob
        wires: list[dict] = []

        def spy(blob, **kw):
            wires.append({"blob": blob.clone(), **kw})
            return self._real(blob, **kw)

        synth_torch.unpack_cols_blob = spy
        return wires

    def __exit__(self, *exc) -> None:
        self._mod.unpack_cols_blob = self._real


def wire_args(wire: dict) -> dict:
    """The keyword arguments of unpack_cols_blob in a wire dict."""
    return {k: wire[k] for k in ("level", "rows", "batch", "nb", "lens",
                                 "has_wrap")}


def unpack_bound(wire: dict) -> tuple[float, str]:
    """Least time (ms) of one unpack call on this wire: the blob read and
    k (2 B a sample), vals and wrap0 written once over HBM bandwidth,
    against the int32 operations its data needs over the int32 ALU rate
    (4 a value of a column that is not zero: shift, mask and the two of
    the sign extension; 4 a column for its ordinal and offset). Returns
    (ms, what bounds it)."""
    level, rows, batch, nb = (wire[k] for k in ("level", "rows", "batch",
                                                 "nb"))
    lens = wire["lens"]
    cols = 1 << level
    n = batch * nb * cols
    cls = wire["blob"][: batch * nb * ((cols + 3) // 4)]
    if hasattr(cls, "cpu"):  # a tensor, on the card or not
        cls = cls.cpu().numpy()
    codes = ((cls.reshape(batch, nb, -1)[..., None] >> (np.arange(4) * 2))
             & 3).reshape(batch, nb, -1)[..., :cols]
    present = [lens[f] >= 2 and lens[3 + f] >= 1 for f in range(3)]
    nz = sum(int((codes == f + 1).sum()) for f in range(3) if present[f])
    wlen = 2 * cols - 2 if wire["has_wrap"] else 0
    nbytes = (len(wire["blob"]) + 2 * n * rows + 4 * batch * nb
              + 4 * batch * wlen)
    ops = 4 * nz * rows + 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unpack_max_err(torch, got, want) -> int:
    """Largest absolute difference of (k, vals, wrap0) triples."""
    err = 0
    for a, b in zip(got, want):
        if (a is None) != (b is None):
            return 1 << 31
        if a is not None and a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max().item()))
    return err


def unpack_rows(torch, shapes, launches, card: str) -> list[dict]:
    """One row per (what, path, wire) of `shapes` (wire: a dict of
    capture_wires, the blob on the card): the unpack kernel held to its
    plain version on the same blob (tolerance 0), its time by CUDA events
    over 20 calls (L2 warm, and flushed before each), the plain version's
    (the eager torch ops the wire paths ran before the kernel), the bound,
    and its launches on the path (path None: those of one call)."""
    from libacm_tpu_torch.ops import synth_torch, unpack_cuda

    rows_out = []
    for what, path, wire in shapes:
        blob, kw = wire["blob"], wire_args(wire)
        got = unpack_cuda.unpack_cols_blob(blob, **kw)
        want = synth_torch.unpack_cols_blob_plain(blob, **kw)
        err = unpack_max_err(torch, got, want)
        if err:
            raise RuntimeError(f"unpack kernel disagrees with its plain "
                               f"version ({what}): max abs err {err}")
        del got, want
        ms = time_ms(torch, lambda: unpack_cuda.unpack_cols_blob(blob, **kw),
                     reps=20)
        cold_ms = time_ms_cold(
            torch, lambda: unpack_cuda.unpack_cols_blob(blob, **kw), reps=20)
        plain_ms = time_ms(torch, lambda: synth_torch.unpack_cols_blob_plain(
            blob, **kw), reps=5)
        bms, by = unpack_bound(wire)
        per_call = unpack_cuda.unpack_launches(kw["level"], kw["batch"],
                                               kw["nb"], kw["has_wrap"])
        n_launch = sum((launches[path] if path in launches else per_call)
                       .get(k, 0) for k in per_call)
        level, rows, B, nb = kw["level"], kw["rows"], kw["batch"], kw["nb"]
        samples = B * nb * (rows << level)
        rows_out.append({
            "name": f"unpack ({what}, {level}/{rows} [{B}, {nb}])",
            "kernel": "unpack", "route": "cuda",
            "source": "libacm_tpu_torch/csrc/unpack.cu",
            "replaces": "libacm_tpu/ops/packing.py:128",
            "path": path if path in launches else "one call",
            "launches": n_launch, "launches_per_call": per_call,
            "max_abs_err": err, "ms": ms, "cold_l2_ms": cold_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bound_share": bms / ms, "library_ms": None,
            "Msamples_per_s": samples / ms / 1e3, "wire_bytes": int(
                blob.numel()), "has_wrap": kw["has_wrap"],
            "level": level, "rows": rows, "B": B, "nb": nb,
        })
        log(f"  unpack {what} {level}/{rows} [{B}, {nb}]: {ms:.4f} ms "
            f"({cold_ms:.4f} with L2 flushed), plain {plain_ms:.4f} ms, "
            f"bound {bms:.5f} ms ({by}), {bms / ms:.1%} of bound {card}")
    return rows_out


def unpack_shapes(wires: dict[str, list[dict]], window: int) -> list:
    """The unpack rows' (what, path, wire): the largest chunk of each
    corpus geometry, the first stream window of `window` blocks, and the
    first 7/16 random-access segments of 8 and of 32 blocks, from the
    wires the bench's counted runs unpacked."""
    per_geom: dict[tuple[int, int], dict] = {}
    for w in wires.get("corpus", []):
        g = (w["level"], w["rows"])
        if g not in per_geom or per_geom[g]["batch"] < w["batch"]:
            per_geom[g] = w
    out = [("corpus chunk", "corpus", w) for _, w in sorted(
        per_geom.items(), key=lambda gw: -gw[1]["batch"] * gw[1]["nb"]
        * (gw[0][1] << gw[0][0]))]
    out += [("stream window", f"stream_window_{window}", w)
            for w in wires.get(f"stream_window_{window}", [])[:1]]
    for nb in (8, 32):
        out += [("random-access segment", "random_access", w)
                for w in [w for w in wires.get("random_access", [])
                          if (w["level"], w["rows"], w["nb"]) == (7, 16, nb)
                          ][:1]]
    return out


# -- the checksum and the width-class block unpack: bounds, rows -------------


#: short spin kernels (torch.cuda._sleep) queued at the start of every
#: profiled window and left out of its counts. On an H100 the profiler at
#: times records none of a window's first device activities (the first two
#: of each window late in a long process) or none of its activities at
#: all, and never drops a later one while it keeps an earlier: so a window
#: that recorded one of these recorded all of fn's, and one that recorded
#: none is run again, up to PROFILE_TRIES windows in all.
PROFILE_GUARD = 4
PROFILE_TRIES = 3


def profiled(torch, fn) -> tuple[float, list]:
    """fn() under torch.profiler, after PROFILE_GUARD spin kernels: (wall
    s, [(device ms, operations, kernel or copy name)] largest first, the
    spin kernels left out). fn runs again, in a new window, while a
    window recorded no spin kernel (PROFILE_TRIES windows at most; then
    the list is empty: the device counts are unknown)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_GUARD):
                torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev, spins = [], 0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            if "spin_kernel" in ev.key:
                spins += ev.count
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            dev.append((us / 1e3, ev.count, ev.key))
        if spins:
            return wall, sorted(dev, reverse=True)
    return wall, []


def per_call(torch, fn, reps: int) -> dict:
    """fn() once to warm up, then: the host wall time a call over `reps`
    calls ending in a synchronise, and the device time and device
    operations a call under torch.profiler over `reps` more (0 where the
    profiler saw no device activity)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, ranked = profiled(torch, lambda: [fn() for _ in range(reps)])
    return {"wall_ms": wall * 1e3 / reps,
            "device_ms": sum(m for m, _, _ in ranked) / reps,
            "ops": sum(c for _, c, _ in ranked) / reps}


def checksum_bound(pcms, ngs) -> tuple[float, str]:
    """Least time (ms) of one masked sum over chunks (pcm, n_good): the
    good words (2 B each) and the span table (32 B a span) read once over
    HBM bandwidth, against one int32 addition a word over the int32 ALU
    rate. Returns (ms, what bounds it)."""
    from libacm_tpu_torch.ops.checksum_cuda import SPAN_WORDS, good_rows

    words = spans = 0
    for pcm, ng in zip(pcms, ngs):
        g = good_rows(ng, pcm.shape[1])
        words += int(g.sum()) * pcm.shape[2]
        spans += int((g > 0).sum())
    nbytes = 2 * words + 8 * (1 + SPAN_WORDS * spans)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = words / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def checksum_row(torch, pcms, ngs, launches: int, card: str) -> dict:
    """The checksum kernel on chunks (pcm on one card, n_good) held to its
    plain version (the digest bit-equal), its time by CUDA events over 20
    launches on one table (L2 warm, and flushed before each), the whole
    call's (table copy, launch, fetch) wall time, device time and device
    operations (per_call) beside the plain version's,
    torch.sum(pcm, dtype=torch.int64) over the same tensors (the same
    bytes without the mask) as the library yardstick, and the bound.
    `launches` are the kernel's on the path."""
    from libacm_tpu_torch.ops import checksum_cuda as cc

    got = int(cc.sum_all(pcms, ngs).item()) & 0xFFFFFFFF
    want = int(cc.sum_all_plain(pcms, ngs).item()) & 0xFFFFFFFF
    if got != want:
        raise RuntimeError(f"checksum kernel {got:#010x} != its plain "
                           f"version {want:#010x}")
    tab, nspans, tiles = cc.plan(np.concatenate(
        [cc.row_spans(pcm, ng) for pcm, ng in zip(pcms, ngs)]))
    table = torch.from_numpy(tab).to(pcms[0].device)
    ms = time_ms(torch, lambda: cc.launch(table, nspans, tiles), reps=20)
    cold_ms = time_ms_cold(torch, lambda: cc.launch(table, nspans, tiles),
                           reps=20)
    lib_ms = time_ms(torch, lambda: [p.sum(dtype=torch.int64) for p in pcms],
                     reps=20)
    call = per_call(torch, lambda: cc.sum_all(pcms, ngs).item(), reps=20)
    plain = per_call(torch, lambda: cc.sum_all_plain(pcms, ngs).item(),
                     reps=5)
    bms, by = checksum_bound(pcms, ngs)
    words = sum(int(cc.good_rows(ng, p.shape[1]).sum()) * p.shape[2]
                for p, ng in zip(pcms, ngs))
    row = {
        "name": f"checksum (corpus, {words} words in {len(pcms)} chunks)",
        "kernel": "checksum", "route": "cuda",
        "source": "libacm_tpu_torch/csrc/checksum.cu",
        "replaces": "libacm_tpu/parallel/corpus.py:413",
        "path": "corpus", "launches": launches, "max_abs_err": 0,
        "ms": ms, "cold_l2_ms": cold_ms,
        "plain_ms": plain["device_ms"], "plain_ops": plain["ops"],
        "plain_wall_ms": plain["wall_ms"],
        "call_ms": call["device_ms"], "call_ops": call["ops"],
        "call_wall_ms": call["wall_ms"],
        "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
        "library_ms": lib_ms, "words": words, "chunks": len(pcms),
        "spans": nspans, "tiles": tiles,
    }
    log(f"  checksum {words} words in {len(pcms)} chunks: kernel {ms:.6f} "
        f"ms ({cold_ms:.6f} with L2 flushed), checksum() "
        f"{row['call_ms']:.6f} ms in {row['call_ops']} device operations "
        f"(wall {row['call_wall_ms']:.3f} ms), plain {row['plain_ms']:.6f} "
        f"ms in {row['plain_ops']} (wall {row['plain_wall_ms']:.3f} ms), "
        f"torch.sum {lib_ms:.6f} ms, bound {bms:.6f} ms ({by}), "
        f"{bms / ms:.1%} of bound {card}")
    return row


def packed_chunk(native, files, n_files: int = 25):
    """ops.packing.PackedBlocks of the first n_files files' blocks, as the
    dense route without the scanner packs a chunk (class counts padded to
    multiples of 64)."""
    from libacm_tpu_torch.ops import packing

    k = np.concatenate([native.scan_bytes(d).k for d in files[:n_files]])
    pads = tuple(-(-c // 64) * 64 for c in packing.class_counts(k))
    return packing.pack_blocks(k, pad_to=pads)


def unpack_blocks_bound(pk) -> tuple[float, str]:
    """Least time (ms) of one unpack_blocks call: the three index arrays
    and the payload of each block's owner row read once (by the JAX
    package's index rules: an idx below 0 names block idx + nb + 1, one
    outside [0, nb) after that names none, and of rows naming one block
    the latest class's; the kernel reads no other row's payload) and k
    (2 B a word) written once over HBM bandwidth, against 2 int32
    operations a word of the 4- and 8-bit owner rows (the sign
    extension's shift pair) over the int32 ALU rate."""
    n = pk.rows * pk.cols
    owner = np.full(pk.nb, -1)
    for c, idx in enumerate((pk.idx4, pk.idx8, pk.idx16)):
        b = np.asarray(idx, np.int64)
        b = np.where(b < 0, b + pk.nb + 1, b)
        owner[b[(b >= 0) & (b < pk.nb)]] = c
    named = [int((owner == c).sum()) for c in range(3)]
    payload = named[0] * ((n + 1) // 2) + named[1] * n + named[2] * 2 * n
    nbytes = (payload + pk.idx4.nbytes + pk.idx8.nbytes + pk.idx16.nbytes
              + 2 * pk.nb * n)
    ops = 2 * (named[0] + named[1]) * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unpack_blocks_row(torch, pk, dev, path: str, launches: int,
                      card: str) -> dict:
    """ops.packing.unpack_blocks on pk's tensors on the card (one launch)
    held to unpack_blocks_plain on the same tensors (tolerance 0), both
    timed by CUDA events over 20 calls (L2 warm, and flushed
    before each), the call's device operations (per_call), the bound,
    and `launches` on `path`."""
    from libacm_tpu_torch.ops import packing

    t = [torch.from_numpy(getattr(pk, f)).to(dev)
         for f in ("p4", "p8", "p16", "idx4", "idx8", "idx16")]
    kw = {"nb": pk.nb, "rows": pk.rows, "cols": pk.cols}
    got = packing.unpack_blocks(*t, **kw)
    want = packing.unpack_blocks_plain(*t, **kw)
    err = (int((got.to(torch.int32) - want.to(torch.int32)).abs().max()
               .item()) if got.numel() else 0)
    if err:
        raise RuntimeError(f"unpack_blocks kernel disagrees with its plain "
                           f"version: max abs err {err}")
    del got, want
    ms = time_ms(torch, lambda: packing.unpack_blocks(*t, **kw), reps=20)
    cold_ms = time_ms_cold(torch, lambda: packing.unpack_blocks(*t, **kw),
                           reps=20)
    plain_ms = time_ms(torch, lambda: packing.unpack_blocks_plain(*t, **kw),
                       reps=20)
    call = per_call(torch, lambda: packing.unpack_blocks(*t, **kw), reps=10)
    bms, by = unpack_blocks_bound(pk)
    n4, n8, n16 = len(pk.idx4), len(pk.idx8), len(pk.idx16)
    padding = sum(int(((i < 0) | (i >= pk.nb)).sum())
                  for i in (pk.idx4, pk.idx8, pk.idx16))
    row = {
        "name": f"unpack_blocks ({pk.rows}x{pk.cols} [{pk.nb}] blocks, "
                f"{n4}/{n8}/{n16} packed 4/8/16-bit rows)",
        "kernel": "unpack_blocks", "route": "cuda",
        "source": "libacm_tpu_torch/csrc/unpack_blocks.cu",
        "replaces": "libacm_tpu/ops/packing.py:184",
        "path": path, "launches": launches, "max_abs_err": err,
        "ms": ms, "cold_l2_ms": cold_ms, "plain_ms": plain_ms,
        "call_ops": call["ops"],
        "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
        "library_ms": None, "packed_bytes": pk.wire_bytes,
        "padding_rows": padding,
        "blocks": pk.nb, "rows": pk.rows, "cols": pk.cols,
    }
    log(f"  unpack_blocks {pk.rows}x{pk.cols} [{pk.nb}], {pk.wire_bytes} "
        f"packed bytes ({padding} padding rows): {ms:.6f} ms ({cold_ms:.6f} "
        f"with L2 flushed) in {row['call_ops']} device operations, plain "
        f"{plain_ms:.6f} ms, bound {bms:.6f} ms ({by}), {bms / ms:.1%} of "
        f"bound {card}")
    return row


def device_compute_msps(rows: list[dict],
                        geoms: dict[tuple[int, int], int]) -> float | None:
    """The synthesis kernel's rate over the corpus geometries: the
    harmonic (time-weighted) mean of the corpus rows' rates, weighted by
    each geometry's share of the corpus's samples."""
    best = {(r["level"], r["rows"]): r["Msamples_per_s"] for r in rows
            if r["path"] == "corpus" and r.get("kernel", "synth") == "synth"}
    if not best:
        return None
    shares = {g: float(geoms.get(g, 1)) for g in best}
    tsec = sum(shares[g] / best[g] for g in best)
    return sum(shares.values()) / tsec


def run_bench(device: str, repeats: int, scale: float, seed: int = 2026, *,
              files: list[bytes] | None = None,
              stream: bytes | None = None,
              deadline: float | None = None, on_first=None) -> dict:
    """Measure everything on `device` ("cuda" or "cpu") and return the
    artifact. `files` and `stream` take a corpus and a long stream that
    the caller built with make_corpus and long_stream at this scale (else
    they are built here). on_first(artifact) is called once the first
    pair is measured: the same dict is filled in place from then on."""
    import torch

    import libacm_tpu_torch as acm
    from libacm_tpu_torch import io as tio
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import kernels
    from libacm_tpu_torch.parallel import (RandomAccessCorpus, build_index,
                                           corpus)
    from libacm_tpu_torch.scan import native

    t_start = time.time()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ident = device_identity(torch, dev)
    card = f"[{ident['nvidia_smi']}]" if on_card else "[cpu rehearsal]"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else None
    rehearsal: dict = {}
    skipped: list[str] = []

    def left(need_s: float) -> bool:
        return deadline is None or time.time() + need_s < deadline

    if not native.available():
        raise RuntimeError("the port's C++ scanner did not build")
    if on_card:
        kernels.build_all()

    # -- data ---------------------------------------------------------------
    t0 = time.perf_counter()
    if files is None:
        files = make_corpus(testing, scale, seed)
    log(f"corpus: {len(files)} files, {sum(map(len, files)) / 1e6:.1f} MB "
        f"({time.perf_counter() - t0:.1f} s)")
    host = corpus.decode_corpus_host(files)
    host_words = sum(len(r.pcm) for r in host if r.pcm is not None)
    geoms: dict[tuple[int, int], int] = {}
    for r in host:
        if r.info is not None and r.pcm is not None:
            g = (r.info.acm_level, r.info.acm_rows)
            geoms[g] = geoms.get(g, 0) + len(r.pcm)
    del host
    threads_all = os.cpu_count() or 1
    launches: dict[str, dict] = {}

    #: the wires the counted runs of each path unpacked (capture_wires)
    wires: dict[str, list[dict]] = {}

    def counted(path: str, fn):
        """fn() with every kernel's launch counters reset before and read
        after, under `path`; the wires it unpacked go to wires[path]."""
        kernels.reset_all()
        with capture_wires() as got:
            out = fn()
        launches[path] = kernels.all_launches()
        wires[path] = got
        return out

    def device_round(**kw) -> int:
        return corpus.decode_corpus_device(files, device=dev,
                                           **kw).checksum()

    # the first device decode: its launches, its chunks' shapes, the
    # checksum every later round must repeat, and the unit of every corpus
    # rate: the samples of the blocks decoded (CorpusSummary.samples),
    # which both decoders synthesize; the results' PCM (host_words) is
    # clamped to each header's sample count
    def first_round():
        dc = corpus.decode_corpus_device(files, device=dev)
        return dc, dc.checksum()

    first, checksum = counted("corpus", first_round)
    total = first.summary.samples
    chunk_shapes = sorted({(b.level, b.rows, b.pcm.shape[0], b.pcm.shape[1])
                           for b in first._buckets})
    del first

    artifact: dict = {
        "metric": "corpus_decode_Msamples_per_s", "value": None,
        "unit": "Msamples/s", "vs_baseline": None,
        "headline_path": "device" if on_card else "rehearsal-cpu",
        "rehearsal": not on_card, "device": ident,
        "scale": scale, "repeats": repeats, "seed": seed,
        "cpu_count": os.cpu_count(), "host_threads": 1,
        "host_all_threads": threads_all,
        "corpus": {"files": len(files), "samples": total,
                   "result_words": host_words, "wire_bytes": sum(map(len, files)),
                   "geometries": {f"{lv}/{rw}": n
                                  for (lv, rw), n in sorted(geoms.items())}},
        **{f: None for f in CARD_FIELDS},
        "host_corpus_Msamples_per_s": None,
        "host_corpus_all_threads_Msamples_per_s": None,
        "stream_whole_host_Msamples_per_s": None,
        "segments_host_per_s": None, "scan_Msamples_per_s": None,
        "reference_Msamples_per_s": None,
        "rehearsal_cpu": None if on_card else rehearsal,
        "budget_skipped": skipped, "bench_wall_s": None,
    }

    def card_field(name: str, value) -> None:
        """A device number goes under its card name on the card; what the
        same path took on the CPU goes under rehearsal_cpu, by a name
        that says neither "device" nor "card"."""
        if on_card:
            artifact[name] = value
        elif name != "value":
            rehearsal["cpu_path_" + name.replace("device_", "")
                      .replace("_card", "")] = value

    # -- 1. corpus: device (cols-wire) against the host decoder -------------
    def host_round(workers: int):
        out = corpus.decode_corpus_host(files, workers=workers)
        got = sum(len(r.pcm) for r in out if r.pcm is not None)
        if got != host_words:
            raise RuntimeError(f"host decode: {got} words, not {host_words}")
        return None

    def same_checksum(name, value):
        if value is not None and value != checksum:
            raise RuntimeError(f"{name}: checksum {value:#010x} != the "
                               f"first decode's {checksum:#010x}")

    t = run_in_turns(
        [("device", device_round), ("host", lambda: host_round(1)),
         ("host_all", lambda: host_round(threads_all))],
        repeats, sync=sync, on_result=same_checksum, deadline=deadline)
    dev_rate = summarize(t["device"], total / 1e6)
    card_field("device_corpus_Msamples_per_s", dev_rate)
    card_field("value", dev_rate["median"])
    card_field("device_vs_host_ratio", turn_ratio(t["device"], t["host"]))
    card_field("device_vs_host_all_threads_ratio",
               turn_ratio(t["device"], t["host_all"]))
    card_field("device_checksum", f"{checksum:#010x}")
    card_field("device_checksums_equal", True)
    artifact["host_corpus_Msamples_per_s"] = summarize(t["host"], total / 1e6)
    artifact["host_corpus_all_threads_Msamples_per_s"] = summarize(
        t["host_all"], total / 1e6)
    artifact["bench_wall_s"] = round(time.time() - t_start, 1)
    log(f"corpus {card}: device {dev_rate['median']:.1f} Msamples/s (median "
        f"of {len(t['device'])}), host 1 thread "
        f"{artifact['host_corpus_Msamples_per_s']['median']:.1f}, "
        f"{threads_all} threads "
        f"{artifact['host_corpus_all_threads_Msamples_per_s']['median']:.1f}")
    if on_first is not None:
        on_first(artifact)  # secured: guarded against a killer from here

    # -- 2. the dense device route beside the cols-wire route ---------------
    if left(30):
        counted("corpus_dense", lambda: same_checksum(
            "dense route", device_round(pack=False)))
        t = run_in_turns(
            [("cols", device_round),
             ("dense", lambda: device_round(pack=False))],
            repeats, warmup=0, sync=sync, on_result=same_checksum,
            deadline=deadline)
        card_field("device_dense_Msamples_per_s",
                   summarize(t["dense"], total / 1e6))
        card_field("device_dense_vs_cols_ratio",
                   turn_ratio(t["dense"], t["cols"]))
    else:
        skipped.append("dense")

    # -- 3. scan alone, the C reference, the copy ---------------------------
    scan = time_native_scan(files, total)
    artifact["scan_Msamples_per_s"] = scan
    ref = ensure_reference()
    if ref is None:
        log("reference binary unavailable; vs_baseline=null")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for i, data in enumerate(files):
                paths.append(pathlib.Path(tmp) / f"f{i:03d}.acm")
                paths[-1].write_bytes(data)
            time_reference_once(ref, paths)  # warm the page cache
            ref_t = [time_reference_once(ref, paths) for _ in range(3)]
        artifact["reference_Msamples_per_s"] = total / min(ref_t) / 1e6
        if on_card:
            artifact["vs_baseline"] = _ratio(
                dev_rate["median"], artifact["reference_Msamples_per_s"])
    if on_card:
        artifact["h2d_pageable_GBps"] = h2d_pageable_gbps(torch, dev)

    # -- 4. the long stream in windows --------------------------------------
    n_blocks, distinct, windows = scaled_stream_shape(scale)
    if stream is None and left(60):
        t0 = time.perf_counter()
        stream = long_stream(testing, build_index, STREAM_SEED, n_blocks,
                             distinct)
        log(f"long stream: {n_blocks} blocks, {len(stream) / 1e6:.1f} MB "
            f"({time.perf_counter() - t0:.1f} s)")
    if stream is not None and left(30):
        sh = corpus.decode_corpus_host([stream])[0]
        if sh.status or sh.filler_words or len(sh.pcm) != n_blocks * 2048:
            raise RuntimeError("the long stream does not decode cleanly on "
                               "the host")
        s_total = len(sh.pcm)
        s_sum = int(sh.pcm.astype(np.int64).sum())
        del sh
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "long.acm"
            path.write_bytes(stream)

            def window_arm(W):
                def arm():
                    pcm, meta = corpus.decode_stream_device(
                        path, device=dev, window_blocks=W)
                    return pcm, meta
                return arm

            def on_window(name, value):
                pcm, meta = value
                if (meta.status or meta.filler_words
                        or _pcm_sum(pcm, s_total) != s_sum):
                    raise RuntimeError(f"stream arm {name}: PCM differs "
                                       "from the host decoder")

            arms = [(str(W), window_arm(W)) for W in windows]
            arms.append(("full", window_arm(None)))
            for name, fn in arms:
                counted(f"stream_window_{name}",
                        lambda: on_window(name, fn()))
            t = run_in_turns(arms, repeats, warmup=0, sync=sync,
                             on_result=on_window, deadline=deadline)
        card_field("stream_window_card_Msamples_per_s",
                   {name: summarize(t[name], s_total / 1e6)
                    for name, _ in arms})
        artifact["stream"] = {"blocks": n_blocks, "samples": s_total,
                              "windows": list(windows)}
    else:
        skipped.append("stream_windows")

    # -- 5. whole files through the stream API ------------------------------
    if left(30):
        whole = mix_class_firsts(files, scale)

        def decode(kind):
            def arm():
                out = []
                for d in whole:
                    s = (acm.acm_open_decoder(d, device=dev)
                         if kind == "card" else
                         acm.AcmStream(tio.BytesSource(d),
                                       synth_backend="host"))
                    out.append(s.read_loop(1 << 30))
                return out
            return arm

        want_bytes = decode("host")()
        w_total = sum(len(b) // 2 for b in want_bytes)

        def on_whole(name, value):
            if value != want_bytes:
                raise RuntimeError(f"whole-file stream ({name}): bytes "
                                   "differ from the host synth")

        counted("stream_whole", lambda: on_whole("card", decode("card")()))
        t = run_in_turns([("card", decode("card")), ("host", decode("host"))],
                         repeats, warmup=0, sync=sync, on_result=on_whole,
                         deadline=deadline)
        card_field("stream_whole_card_Msamples_per_s",
                   summarize(t["card"], w_total / 1e6))
        card_field("stream_whole_card_vs_host_ratio",
                   turn_ratio(t["card"], t["host"]))
        artifact["stream_whole_host_Msamples_per_s"] = summarize(
            t["host"], w_total / 1e6)
        del want_bytes
    else:
        skipped.append("stream_whole")

    # -- 6. random access ----------------------------------------------------
    n_seg = max(20, int(N_SEGMENTS * scale)) if scale < 1 else N_SEGMENTS
    # a round of windows on the card takes about 5 s at scale 1
    if left(12 * (repeats + 1) * n_seg / N_SEGMENTS if on_card else 10):
        rac = RandomAccessCorpus(files, device=dev)
        rah = RandomAccessCorpus(files, backend="host")
        rng = np.random.default_rng(5)
        wins = []
        for _ in range(n_seg):
            i = int(rng.integers(0, len(files)))
            tot = rah.pcm_total(i)  # builds (and caches) the index
            rac.pcm_total(i)
            wins.append((i, int(rng.integers(0, max(tot, 1))),
                         int(rng.integers(1, SEGMENT_FRAMES + 1))))
        want_seg = [rah.read(*w) for w in wins]

        def on_seg(name, value):
            for w, g, h in zip(wins, value, want_seg):
                if g.shape != h.shape or not np.array_equal(g, h):
                    raise RuntimeError(f"window {w} ({name}) differs from "
                                       "backend='host'")

        counted("random_access", lambda: on_seg(
            "card", [rac.read(*w) for w in wins]))
        t = run_in_turns(
            [("card", lambda: [rac.read(*w) for w in wins]),
             ("host", lambda: [rah.read(*w) for w in wins])],
            repeats, warmup=0, sync=sync, on_result=on_seg,
            deadline=deadline)
        card_field("segments_card_per_s", summarize(t["card"], n_seg))
        card_field("segments_card_vs_host_ratio",
                   turn_ratio(t["card"], t["host"]))
        artifact["segments_host_per_s"] = summarize(t["host"], n_seg)
        artifact["segments"] = {"windows": n_seg,
                                "max_frames": SEGMENT_FRAMES}
        del rac, rah, want_seg
    else:
        skipped.append("random_access")

    # -- 7. kernel rows and the parity verdict (the card only) --------------
    card_field("device_launches", launches)
    if on_card:
        per_geom: dict[tuple[int, int], tuple[int, int]] = {}
        for level, rows, B, nb in chunk_shapes:  # a geometry's largest chunk
            if per_geom.get((level, rows), (0, 0))[0] < B:
                per_geom[(level, rows)] = (B, nb)
        shapes = [("corpus chunk", "corpus", lv, rw, B, nb)
                  for (lv, rw), (B, nb) in sorted(
                      per_geom.items(),
                      key=lambda g: -g[1][0] * g[1][1] * (g[0][1] << g[0][0]))]
        if f"stream_window_{windows[0]}" in launches:
            shapes.append(("stream window", f"stream_window_{windows[0]}",
                           7, 16, 1, windows[0]))
        shapes += EXTRA_KERNEL_SHAPES
        rows = kernel_rows(torch, dev, shapes, launches, card)
        rows += unpack_rows(torch, unpack_shapes(wires, windows[0]),
                            launches, card)
        dc = corpus.decode_corpus_device(files, device=dev)
        (pcms, ngs), = corpus._checksum_inputs(dc._buckets).values()
        rows.append(checksum_row(torch, pcms, ngs,
                                 launches["corpus"]["checksum"], card))
        del dc, pcms
        rows.append(unpack_blocks_row(torch, packed_chunk(native, files), dev,
                                      "one call", 1, card))
        artifact["kernel_rows"] = rows
        artifact["device_compute_Msamples_per_s"] = device_compute_msps(
            rows, geoms)
        sweep_left = (deadline - time.time() - 10) if deadline else 300.0
        artifact["parity_sweep"] = (
            parity_sweep(min(300.0, sweep_left)) if sweep_left > 60
            else "skipped (budget exhausted)")
        log(f"parity sweep: {artifact['parity_sweep']}")
    artifact["bench_wall_s"] = round(time.time() - t_start, 1)
    return artifact


def _parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="benchmark of libacm_tpu_torch on one NVIDIA card")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (default: the card, an error without one) or "
                         "cpu (a rehearsal: card fields stay null)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed rounds of each group after its warm-up")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink corpus counts, blocks and windows (< 1: "
                         "rehearsal sizes)")
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args(argv)
    if args.repeats < 1 or not 0 < args.scale <= 1:
        ap.error("--repeats must be >= 1 and 0 < --scale <= 1")
    return args


def _main(args: argparse.Namespace, t_start: float) -> int:
    budget_s = float(os.environ.get(BUDGET_ENV, "600"))
    art = run_bench(args.device, args.repeats, args.scale, args.seed,
                    deadline=t_start + budget_s, on_first=set_artifact)
    set_artifact(art)
    art["bench_wall_s"] = round(time.time() - t_start, 1)
    emit_artifact()
    return 0


def main(argv=None) -> int:
    t_start = time.time()
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if args.device is None:
        args.device = "cuda"
    if args.device == "cuda" and not torch.cuda.is_available():
        log("bench_torch: no CUDA device (torch.cuda.is_available() is "
            "false); pass --device cpu for a rehearsal")
        return 2
    _install_artifact_guard()
    try:
        return _main(args, t_start)
    except Exception as exc:
        # no measurement on the CPU in place of a run that failed: what was
        # secured goes out marked, and the exit code says it crashed
        log(f"bench crashed ({type(exc).__name__}: {exc})")
        import traceback

        traceback.print_exc(file=sys.stderr)
        if _ARTIFACT is not None:
            _ARTIFACT["crashed"] = f"{type(exc).__name__}: {exc}"
            _ARTIFACT["bench_wall_s"] = round(time.time() - t_start, 1)
            emit_artifact()
        return 1


if __name__ == "__main__":
    sys.exit(main())
