#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. card:    the card's name and power limit (nvidia-smi); build the CUDA
            kernels of ops.kernels.MODULES (the synthesis, the cols-wire
            unpack, the checksum and the block unpack; one nvcc each,
            sm_90a) and the port's C++ scanner, all started together,
            while a thread encodes phase 3's corpus and phase 6's long
            stream.
2. parity:  each synthesis route against the plain torch version on the
            card, random inputs from a numpy seed, on the PARITY
            geometries; tolerance 0 (PCM and final carry bit-equal); every
            kernel launched, each geometry exactly the launches of its
            route. The unpack kernel (csrc/unpack.cu) against its plain
            version (k, vals and wrap0 bit-equal, one launch a call) on
            bench_torch.UNPACK_EDGES, UNPACK_RANDOM seeded random wires, a
            wire of RACE_WIRE's 2,000 tiles decoded RACE_TIMES times in a
            row (look-back races would show as a difference), and
            the wires the paths give it (captured by
            bench_torch.capture_wires): every chunk of the bench corpus mix,
            every window of the long stream at W = 2048, and the segments
            of 40 random-access windows.
3. corpus:  decode_corpus_device(device="cuda") over the bench corpus mix
            (bench.py's counts, ~120 M samples) and its checksum() — launch
            counters reset just before and read just after: one synthesis
            launch and one unpack launch a chunk, one checksum launch —
            checked file by file against the port's decode_corpus_host
            (PCM, status, filler words), and its checksum() against the
            same masked sum taken on the host.
4. numbers: one corpus decode under torch.profiler (wall, host scan, the
            card's busy share and its kernels by time), each kernel's time
            per bench geometry with CUDA events beside the plain version's
            time and the bound, its launch shape (shared memory per CTA,
            resident CTAs per SM); the unpack's time on the largest chunk
            of each corpus geometry, a stream window and random-access
            segments of 8 and 32 blocks, beside its plain version (the
            eager torch ops) and bench_torch.unpack_bound.
5. reference API on the card, four paths, each with the launch
            counters reset just before it and read just after:
            stream — every tests/fixtures file and one full-size file of
            each bench-mix class (and a bit-flipped one) through
            acm_open_file/acm_open_decoder(device="cuda") + read_loop,
            equal to the same stream under synth_backend="host" and to
            the golden .raw; seeks forward, back to 0, and the
            stale-amp-table seek sequences;
            random access — 300 random windows of 1-50,000 frames over
            the 190-file corpus through RandomAccessCorpus(device="cuda"),
            equal to backend="host", one unpack launch a segment,
            exactly 4 device operations a segment under the profiler;
            read_batch — 8 batches of 16 crops of 8,192 frames over 24
            7/16 clips (one cut short, one shorter than a crop, crops
            past a clip's end zero-padded) through
            RandomAccessCorpus(device="cuda").read_batch, each batch equal
            to the plain route (device="cpu") and to backend="host" padded,
            one unpack and one fused launch a batch, and the unpack on its
            [16, 8] wire timed beside its plain version and its bound;
            CLI — `acmtool -d -r -o` in process on three fixtures, equal
            to the goldens. The stream and the CLI synthesize dense k: no
            unpack launch.
            Then the kernel's time at the shapes these paths give it
            (B = 1, and read_batch's [16, 8]), and at blocks that fit one
            CTA per SM or none, beside its plain version and its bound.
6. device lists, windows and processes, each part with the launch
            counters reset just before it and read just after:
            stream windows — one seeded 7/16 mono stream of STREAM_BLOCKS
            blocks (longer than any file the games ship; see long_stream
            for how it is built) through decode_stream_device(device=
            "cuda", window_blocks=W) for a W that divides the block count
            and one that does not, from a path and from a read()-only
            object, and the full-file call: PCM, status and filler equal
            to decode_corpus_host of the same bytes, one synthesis launch
            and one unpack call a window, no copy from the card while it
            decodes (the carry is never fetched) and exactly 3 device
            operations a window and 2 a decode under the profiler; a
            rows == 1 stream (one fused launch a window) and a level-0
            stream (one level-0 launch a window); a
            stale-amp-table stream through the host fallback and through
            the ValueError;
            carry-in — the kernel on [0, nb) in one launch equal to
            [0, m) then [m, nb) with wrapf handed over on the card, both
            equal to the plain version;
            sharded corpus — phase 3's corpus through
            decode_corpus_device(devices=[cuda:0, cuda:0]) (and over every
            card where there are several): checksum() equal to phase 3's
            in one checksum launch, results equal to decode_corpus_host,
            one unpack call a group; two processes — two ranks of
            tests/_torch_dist_worker.py over gloo, each decoding its
            manifest shard on the card, totals equal to the one-process
            summary, one checksum launch a rank.
7. the dense route and the bench, each with the launch counters reset
            just before and read just after:
            dense route — decode_corpus_device(device="cuda", pack=False)
            over two full-size files of every bench-mix class and the
            hostile ones (dense int16 k straight into the kernel), and
            pack=True with the scanner answering "not built" for that call
            (oracle scan of short files of every class, pack_blocks, the
            block unpack kernel on the card, one launch a chunk): PCM,
            status and filler equal to decode_corpus_host, checksum() equal
            to the host sum and to the cols-wire route's (one checksum
            launch), the fused and level-0 kernels launched;
            checksum and block unpack — each kernel held to its plain
            version on the bench corpus (checksum() over the whole
            corpus's PCM; unpack_blocks on a 25-file 7/16 chunk packed as
            the dense route packs it), timed with the L2 warm and flushed
            beside its bound (the checksum beside torch.sum over the same
            tensors), its device operations counted under the profiler
            (exactly 3 a checksum(), 1 an unpack_blocks call);
            bench — bench_torch.run_bench in process on the card at the
            full corpus width, on phase 3's files and phase 6's stream
            (no second encode), three rounds a group: every card field
            non-null and finite, no group skipped, its checksums equal to
            phase 3's, its parity verdict PASS; its JSON line is printed.
            Last, the kernel's time at the shapes phases 6 and 7 gave it
            ([1, W] with a non-zero carry, the largest sharded and dense
            groups), and one JSON line of kernels: a row for each route
            that ran (the main path's, those of the other paths' shapes,
            and the wide passes and tail of blocks over 227 KB, with their
            launches in phase 2; the unpack's rows of phase 4, with their
            launches on the corpus, the stream windows and random access;
            and the checksum's and the block unpack's rows, with their
            launches on every path that ran them).

Phases 1-3 and the checks of phases 4-6 run at the depth they always had.
Given to the bench (phase 7), which runs them in turns with repeats: phase
4's three timed corpus decodes, phase 5's whole-file stream rounds (card
against host synth) and its timing of 1,000 random-access windows (300 are
still held to the host route here, and the bench holds its 1,000 to it
too), phase 6's second decode of each stream window from each source and,
on a machine with one card, its timing of one device against a device
list. Each phase prints the seconds it took.

The last line is {"ok": true, "device": {...}}. Needs no network; imports
torch, numpy, libacm_tpu_torch and bench_torch.py (the corpus mix, the long
stream, the kernel's bound and its timer are defined there, once).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# the corpus mix and long stream (built from a seed), the kernel's bound and
# its timer have one definition, in the port's bench
import bench_torch  # noqa: E402
from bench_torch import (MIX, STREAM_BLOCKS, STREAM_DISTINCT,  # noqa: E402
                         STREAM_SEED, STREAM_WINDOWS, UNPACK_EDGES, bound,
                         capture_wires, edge_wire, kernel_route, long_stream,
                         make_corpus, mix_class_firsts, random_wire,
                         route_launches, unpack_max_err, unpack_shapes,
                         wire_args)
from bench_torch import max_err as _max_err  # noqa: E402
from bench_torch import profiled as _profiled  # noqa: E402
from bench_torch import random_inputs as _random_inputs  # noqa: E402
from bench_torch import time_ms as _time_ms  # noqa: E402
from bench_torch import time_ms_cold as _time_ms_cold  # noqa: E402

#: phase 5's kernel shapes, one file per launch: (what, level, rows, nb).
#: Whole bench-mix files through the stream; read_segment spans (a
#: window's blocks plus one warm-up block, padded to 8 blocks); a rows == 1
#: file (fused, two warm-up blocks a span) of a 7/16 file's length; blocks
#: that leave room for one CTA per SM, and blocks over 227 KB (wide flat
#: passes, then the tail's tiles)
NEW_SHAPES = [("stream, whole file", 7, 16, 300),
              ("stream, whole file", 4, 40, 1200),
              ("stream, whole file", 10, 4, 150),
              ("stream, whole file", 0, 2048, 400),
              ("read_segment, short", 7, 16, 8),
              ("read_segment, 50,000 frames", 7, 16, 32),
              ("read_segment, short", 4, 40, 8),
              ("stream, rows == 1", 7, 1, 4800),
              ("one CTA per SM", 13, 2, 4),
              ("blocks over 227 KB", 14, 1, 4),
              ("blocks over 227 KB", 15, 16, 3)]
#: phase 5's batched shapes: (what, level, rows, B, nb); read_batch's 16
#: crops of 8,192 frames, each its blocks plus one warm-up, padded to 8
BATCH_SHAPES = [("read_batch, 16 crops", 7, 16, 16, 8)]
#: phase 5's read_batch: batches, crops a batch, frames a crop, 7/16 clips
READ_BATCHES = 8
READ_BATCH_B = 16
READ_CROP_FRAMES = 8192
READ_CLIPS = 24
#: phase 6's rows == 1 and level-0 streams: (what, level, rows, blocks,
#: window)
PASS_STREAMS = [("rows == 1", 7, 1, 4800, 512), ("level 0", 0, 2048, 400, 64)]
#: phase 6's split launches: (level, rows, nb, blocks in the first launch)
SPLITS = [(7, 16, 2048, 1000), (4, 40, 1200, 7), (10, 4, 150, 77),
          (7, 1, 4800, 2400), (0, 2048, 400, 100)]

#: phase 5's random-access windows (phase 7's bench reads 1,000)
RA_WINDOWS = 300

#: phase 5's CLI fixtures: a fused, a level-0 and a rows == 1 stream
CLI_FIXTURES = ("speech_22k_mono", "level0", "rows1")

#: kernel parity geometries (level, rows, files, blocks per file): the
#: bench geometries, then the extremes, then the fused route's edges
#: (many files; nb below one tile; n % 8 != 0, where k is staged in
#: copies narrower than 16 bytes; spans of several tiles cut mid-file),
#: then rows == 1 (two warm-up blocks a span from level 2; 7/1 x 100 has
#: spans of one block, so spans start at block 1), blocks that leave room
#: for one CTA per SM, level 0 at a vector width of 2, and blocks over
#: 227 KB with no wide pass and with two
PARITY = [(7, 16, 3, 41), (4, 40, 2, 37), (10, 4, 2, 9), (0, 2048, 2, 5),
          (10, 1, 2, 6), (14, 1, 1, 4), (15, 16, 1, 3), (5, 33, 2, 7),
          (9, 3, 2, 6), (7, 16, 40, 13), (7, 16, 1, 3), (1, 3, 2, 9),
          (2, 3, 3, 7), (7, 16, 100, 20), (4, 40, 200, 40),
          (1, 1, 2, 9), (2, 1, 3, 7), (7, 1, 2, 40), (12, 1, 1, 5),
          (7, 1, 1, 100), (13, 2, 1, 4), (12, 4, 2, 3), (10, 16, 2, 8),
          (0, 50, 2, 9), (11, 16, 2, 2), (13, 3, 2, 2)]


#: phase 2's random unpack wires (bench_torch.random_wire seeds)
UNPACK_RANDOM = range(24)
#: the unpack kernels, as one call launches them, joined like a route
UNPACK_ROUTE = "unpack"
#: phase 2's look-back race check: a synthetic_wire of 2,000 column tiles
#: (seed, level, rows, batch, nb), decoded this many times in a row
RACE_WIRE = (99, 10, 4, 10, 400)
RACE_TIMES = 50


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def expected(synth_cuda, per_call: dict, times: int = 1) -> dict:
    """Every launch counter after `times` calls of per_call launches."""
    return {k: per_call.get(k, 0) * times for k in synth_cuda.launches}


def path_kernels(synth_cuda, shapes) -> set:
    """The kernels that (level, rows, nb, ...) shapes launch."""
    return {k for level, rows, nb, *_ in shapes
            for k in synth_cuda.kernel_launches(level, rows, nb)}


#: the kernels of the bench corpus mix: 7/16, 4/40, 10/4 fused, 0/2048
CORPUS_KERNELS = ("synth_fused", "synth_level0")


def unpack_expected(unpack_cuda, calls: int) -> dict:
    """Every unpack counter after `calls` calls with columns (one kernel
    each)."""
    return {k: calls for k in unpack_cuda.launches}


def unpack_parity(torch, unpack_cuda, synth_torch, what: str, wires) -> int:
    """The unpack kernel ≡ its plain version on each wire (dicts with the
    blob on the card), tolerance 0, each call exactly the launches of
    unpack_launches. Returns the number of launches."""
    from libacm_tpu_torch.ops import kernels

    n = 0
    for wire in wires:
        blob, kw = wire["blob"], wire_args(wire)
        kernels.reset_all()
        got = unpack_cuda.unpack_cols_blob(blob, **kw)
        torch.cuda.synchronize()
        launched = dict(unpack_cuda.launches)
        per_call = unpack_cuda.unpack_launches(kw["level"], kw["batch"],
                                               kw["nb"], kw["has_wrap"])
        check(launched == {k: per_call.get(k, 0) for k in launched},
              f"unpack {what}: launches {launched}, expected {per_call}")
        err = unpack_max_err(torch, got,
                             synth_torch.unpack_cols_blob_plain(blob, **kw))
        check(err == 0, f"unpack kernel disagrees with plain ({what}, "
              f"{kw['level']}/{kw['rows']} [{kw['batch']}, {kw['nb']}]): "
              f"max abs err {err}")
        n += sum(launched.values())
        del got
    return n


def unpack_race(torch, unpack_cuda, synth_torch, dev) -> None:
    """RACE_WIRE's 2,000 column tiles (and their width tiles), each call's
    look-back resolved in whatever order the CTAs run: the kernel held to
    the plain version once, then RACE_TIMES calls in a row each equal to
    that first result."""
    seed, level, rows, batch, nb = RACE_WIRE
    wire = bench_torch.synthetic_wire(seed, level, rows, batch, nb)
    blob, kw = torch.from_numpy(wire["blob"]).to(dev), wire_args(wire)
    p = unpack_cuda.plan(**kw)
    check(p["nct"] >= 2000, f"the race wire has {p['nct']} tiles")
    first = unpack_cuda.unpack_cols_blob(blob, **kw)
    err = unpack_max_err(torch, first,
                         synth_torch.unpack_cols_blob_plain(blob, **kw))
    check(err == 0, f"unpack kernel disagrees with plain on the race "
          f"wire: max abs err {err}")
    bad = 0
    for _ in range(RACE_TIMES):
        got = unpack_cuda.unpack_cols_blob(blob, **kw)
        bad += not all(torch.equal(a, b) for a, b in zip(got[:2], first[:2]))
    torch.cuda.synchronize()
    check(bad == 0, f"the race wire differed in {bad} of {RACE_TIMES} calls")
    print(f"phase 2: unpack: the race wire ({p['nct']} column tiles, "
          f"{sum(p['nwt'])} width tiles) equal to the plain version, then "
          f"{RACE_TIMES} calls in a row equal to the first")


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


def print_breakdown(label: str, wall: float, ranked: list, card: str,
                    host_note: str = "") -> None:
    """The device's busy share of the wall time and its kernels by time."""
    busy = sum(ms for ms, _, _ in ranked)
    if not busy:
        print(f"{label}: profiler recorded no device time: breakdown not "
              "measured")
        return
    print(f"{label}: profiled wall {wall * 1e3} ms{host_note}, device busy "
          f"{busy} ms ({busy / (wall * 1e3):.1%} of wall) {card}")
    for i, (ms, count, key) in enumerate(ranked):
        if i < 8 or any(k in key for k in ("synth_", "unpack_", "checksum_")):
            print(f"  device #{i + 1}: {ms} ms in {count} x {key[:90]}")


def profile_breakdown(torch, corpus, files, card: str) -> None:
    """One corpus decode under torch.profiler, with the host scan time."""
    out = []
    wall, ranked = _profiled(torch, lambda: out.append(
        corpus.decode_corpus_device(files, device="cuda")))
    print_breakdown("phase 4: decode", wall, ranked, card,
                    f", host scan {out[-1].summary.scan_s * 1e3} ms")


def host_breakdown(torch, fn, label: str, top: int = 8) -> None:
    """fn() under cProfile: the host functions with the most time of their
    own (the profiler slows Python frames, not native calls, so the
    shares lean towards Python)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats  # {(file, line, name): (cc, nc, tt, ct, _)}
    total = sum(v[2] for v in stats.values())
    print(f"{label}: host time by function, own time of {total * 1e3:.1f} "
          "ms under cProfile:")
    for (file, line, name), v in sorted(stats.items(),
                                        key=lambda kv: -kv[1][2])[:top]:
        where = (name if file == "~" else
                 f"{pathlib.Path(file).name}:{line} {name}")
        print(f"  host: {v[2] * 1e3:.1f} ms in {v[1]} x {where[:90]}")


def _drain(stream, errors) -> bytes:
    """read_loop to EOF, reading on past decode errors (each raised read
    consumes one failed attempt, as the reference's next read does)."""
    out = bytearray()
    while True:
        try:
            b = stream.read_loop(1 << 16)
        except errors:
            continue
        if not b:
            return bytes(out)
        out += b


def _seek_drain(stream, errors, pre, tgt) -> bytes:
    """Read `pre` bytes (None: drain to EOF), seek to frame tgt, drain:
    the sequences of tests/test_ref_live.py's stale-amp-table seeks."""
    if pre is None:
        _drain(stream, errors)
    else:
        left = pre
        while left > 0:
            try:
                b = stream.read_loop(min(1 << 16, left))
            except errors:
                break
            if not b:
                break
            left -= len(b)
    stream.seek_pcm(tgt)
    return _drain(stream, errors)


def phase2_path_wires(torch, corpus, files, stream_data) -> dict:
    """The wires the main paths unpack, each blob copied on the card as the
    path gave it (bench_torch.capture_wires), under the bench's path names:
    every chunk of the bench corpus mix ("corpus"), every window of the
    long 7/16 stream at W = STREAM_WINDOWS[0] ("stream_window_<W>"), and
    the segments of 40 seeded random-access windows ("random_access")."""
    from libacm_tpu_torch.parallel import RandomAccessCorpus

    out = {}
    with capture_wires() as wires:
        corpus.decode_corpus_device(files, device="cuda").block_until_ready()
    out["corpus"] = wires
    with capture_wires() as wires:
        corpus.decode_stream_device(_ReadOnly(stream_data), device="cuda",
                                    window_blocks=STREAM_WINDOWS[0])
    out[f"stream_window_{STREAM_WINDOWS[0]}"] = wires
    rac = RandomAccessCorpus(files, device="cuda")
    rng = np.random.default_rng(9)
    with capture_wires() as wires:
        for _ in range(40):
            i = int(rng.integers(0, len(files)))
            rac.read(i, int(rng.integers(0, max(rac.pcm_total(i), 1))),
                     int(rng.integers(1, 50_001)))
    out["random_access"] = wires
    torch.cuda.synchronize()
    for what, wires in out.items():
        check(len(wires) > 0, f"phase 2: no {what} wire was unpacked")
    return out


def phase5_stream(torch, synth_cuda, files, card) -> dict:
    """Every fixture and one full-size file per bench-mix class through the
    port's stream on the card, each against the same stream under
    synth_backend="host" (and its golden .raw); seeks. Returns the
    launches of those checks."""
    import libacm_tpu_torch as acm
    from libacm_tpu_torch import io as tio
    from libacm_tpu_torch.format import cli_total_bytes
    from libacm_tpu_torch.ops import kernels, unpack_cuda

    err = acm.AcmException
    fixtures = sorted((ROOT / "tests" / "fixtures").glob("*.acm"))
    check(len(fixtures) >= 20, "tests/fixtures is missing files")
    kernels.reset_all()
    n = 0
    for path in fixtures:
        card_s = acm.acm_open_file(path, device="cuda")
        host_s = acm.AcmStream(tio.FileSource(path), synth_backend="host")
        got = _drain(card_s, err)
        check(got == _drain(host_s, err),
              f"stream {path.name}: card bytes differ from the host synth")
        golden = ROOT / "tests" / "goldens" / f"{path.stem}.raw"
        if golden.exists():
            # acmtool -d -r: 8 KiB reads until an error or EOF, then zeros
            s = acm.acm_open_file(path, device="cuda")
            total = cli_total_bytes(s.total_values, s.channels)
            out = bytearray()
            while len(out) < total:
                try:
                    b = s.read_loop(8192)
                except err:
                    break
                if not b:
                    break
                out += b
            out += bytes(max(0, total - len(out)))
            check(bytes(out) == golden.read_bytes(),
                  f"stream {path.name}: differs from its golden .raw")
        n += 1
    for data in files:
        card_s = acm.acm_open_decoder(data, device="cuda")
        host_s = acm.AcmStream(tio.BytesSource(data), synth_backend="host")
        check(_drain(card_s, err) == _drain(host_s, err),
              "bench-mix stream: card bytes differ from the host synth")
        n += 1
    # seeks: forward to the middle, then back to 0
    for src in fixtures + files:
        card_s = (acm.acm_open_file(src, device="cuda")
                  if isinstance(src, pathlib.Path)
                  else acm.acm_open_decoder(src, device="cuda"))
        host_s = acm.AcmStream(
            tio.FileSource(src) if isinstance(src, pathlib.Path)
            else tio.BytesSource(src), synth_backend="host")
        mid = host_s.pcm_total() // 2
        check(card_s.seek_pcm(mid) == host_s.seek_pcm(mid)
              and _drain(card_s, err) == _drain(host_s, err),
              "seek to the middle: card differs from the host synth")
        check(card_s.seek_pcm(0) == host_s.seek_pcm(0)
              and _drain(card_s, err) == _drain(host_s, err),
              "seek back to 0: card differs from the host synth")
    stale = [("seek_readahead_stale", pre, tgt)
             for pre, tgt in ((64, 0), (64, 1), (128, 0))]
    stale += [("seek_terminal_att_stale", None, tgt) for tgt in (0, 1, 7)]
    for name, pre, tgt in stale:
        path = ROOT / "tests" / "fixtures" / f"{name}.acm"
        got = _seek_drain(acm.acm_open_file(path, device="cuda"), err, pre,
                          tgt)
        want = _seek_drain(acm.AcmStream(tio.FileSource(path),
                                         synth_backend="host"), err, pre, tgt)
        check(got == want, f"{name} ({pre}, {tgt}): card differs from host")
    launches = dict(synth_cuda.launches)
    unpacked = dict(unpack_cuda.launches)
    print(f"phase 5: stream: {n} streams ({len(fixtures)} fixtures, "
          f"{len(files)} full-size bench-mix files) equal to "
          f"synth_backend='host' and the goldens; "
          f"{len(fixtures) + len(files)} middle and back-to-0 seeks and "
          f"{len(stale)} stale-amp-table seek sequences equal; launches "
          f"{launches} {unpacked}")
    for kernel in CORPUS_KERNELS:
        check(launches[kernel] > 0,
              f"the stream path launched {kernel} no time")
    check(not any(unpacked.values()), f"the stream path (dense k) launched "
          f"the unpack: {unpacked}")
    # one profiled pass over the clean full-size files (the card against
    # synth_backend="host" in turns is bench_torch.py's, phase 7)
    clean = files[:-1]
    wall, ranked = _profiled(torch, lambda: [
        acm.acm_open_decoder(d, device="cuda").read_loop(1 << 30)
        for d in clean])
    print_breakdown("phase 5: stream decode", wall, ranked, card)
    return launches | unpacked


def phase5_random_access(torch, synth_cuda, corpus_files, card) -> dict:
    """RA_WINDOWS random windows of 1-50,000 frames over the corpus through
    RandomAccessCorpus on the card, each equal to backend="host" (the
    bench's 1,000 windows, each held to the host route too, follow in
    phase 7)."""
    from libacm_tpu_torch.ops import kernels, unpack_cuda
    from libacm_tpu_torch.parallel import RandomAccessCorpus

    rac = RandomAccessCorpus(corpus_files, device="cuda")
    host = RandomAccessCorpus(corpus_files, backend="host")
    rng = np.random.default_rng(5)
    windows = []
    for _ in range(RA_WINDOWS):
        i = int(rng.integers(0, len(corpus_files)))
        total = host.pcm_total(i)  # builds (and caches) the index
        rac.pcm_total(i)
        windows.append((i, int(rng.integers(0, max(total, 1))),
                        int(rng.integers(1, 50_001))))
    kernels.reset_all()
    got = [rac.read(i, s, n) for i, s, n in windows]
    launches = dict(synth_cuda.launches)
    unpacked = dict(unpack_cuda.launches)
    want = [host.read(i, s, n) for i, s, n in windows]
    frames = 0
    for (i, s, n), g, w in zip(windows, got, want):
        check(g.shape == w.shape and np.array_equal(g, w),
              f"window ({i}, {s}, {n}): card differs from backend='host'")
        frames += len(g)
    print(f"phase 5: random access: {RA_WINDOWS} windows ({frames} frames) "
          f"over {len(corpus_files)} files equal to backend='host'; launches "
          f"{launches} {unpacked}")
    check(sum(launches.values()) > 0, "random access launched no kernel")
    # one unpack launch a segment, beside its synthesis
    check(unpacked == unpack_expected(unpack_cuda, sum(launches.values())),
          f"random access: unpack launches {unpacked} for "
          f"{sum(launches.values())} segments")

    def window() -> None:
        kernels.reset_all()  # the launches of the window that is kept
        for w in windows[:100]:
            rac.read(*w)

    wall, ranked = _profiled(torch, window)
    print_breakdown("phase 5: 100 random-access windows", wall, ranked, card)
    segs = sum(synth_cuda.launches.values())
    ops = sum(count for _, count, _ in ranked)
    print(f"phase 5: {ops} device operations for {segs} segments, "
          f"{ops / max(segs, 1)} a segment (copies in and out included)")
    check(segs > 0 and ops == 4 * segs,
          f"random access ran {ops / max(segs, 1)} device operations a "
          "segment, not 4 (a copy in, the unpack, the synthesis and a copy "
          "out)")
    return launches | unpacked


def phase5_read_batch(torch, synth_cuda, testing, card) -> dict:
    """RandomAccessCorpus.read_batch on the card: READ_BATCHES batches of
    16 distinct 8,192-frame crops over READ_CLIPS 7/16 clips of 3-109
    blocks, one cut to 60 % of its bytes and one shorter than a crop; the
    first batch holds both, its crop of the cut clip reaching past the
    clip's decodable end. Each batch bit-equal to the plain route (the
    same call on device="cpu": the plain unpack and synthesis) and to the
    per-crop backend="host" reads zero-padded; the launch counters reset
    before each batch and read after it: exactly one unpack and one fused
    synthesis launch. Returns the launches and the unpack kernel's row on
    the first batch's wire."""
    from libacm_tpu_torch.ops import kernels, unpack_cuda
    from libacm_tpu_torch.parallel import RandomAccessCorpus

    B, F = READ_BATCH_B, READ_CROP_FRAMES
    rng = np.random.default_rng(20)
    clips = [testing.speech_acm_bytes(rng, level=7, rows=16,
                                      n_blocks=int(rng.integers(12, 110)))
             for _ in range(READ_CLIPS - 1)]
    clips[0] = clips[0][: int(len(clips[0]) * 0.6)]  # cut mid-stream
    clips.append(testing.speech_acm_bytes(rng, level=7, rows=16, n_blocks=3))
    cut, short = 0, len(clips) - 1
    kw = dict(max_cached_files=len(clips))
    rac = RandomAccessCorpus(clips, device="cuda", **kw)
    plain = RandomAccessCorpus(clips, device="cpu", **kw)
    host = RandomAccessCorpus(clips, backend="host", **kw)
    frames = [host.pcm_total(i) for i in range(len(clips))]
    decodable = len(host.read(cut, 0, frames[cut]))
    check(decodable < frames[cut], "the cut clip decodes whole")
    draws = []
    for b in range(READ_BATCHES):
        files = rng.permutation(len(clips))[:B]
        if b == 0:
            files = np.concatenate([[cut, short], [f for f in files if f not in
                                                   (cut, short)][: B - 2]])
        starts = [int(rng.integers(0, max(frames[f] - F, 0) + 1))
                  for f in files]
        if b == 0:
            starts[0] = decodable - F // 2  # past the cut clip's end
        draws.append(([int(f) for f in files], starts))
    for i in range(len(clips)):  # every index built before the batches
        rac.pcm_total(i)
    per_call = expected(synth_cuda, synth_cuda.kernel_launches(7, 16, 8))
    launches = expected(synth_cuda, {})
    padded = 0
    with bench_torch.capture_wires() as wires:
        for files, starts in draws:
            kernels.reset_all()
            got = rac.read_batch(files, starts, F)
            torch.cuda.synchronize()
            launched, unpacked = (dict(synth_cuda.launches),
                                  dict(unpack_cuda.launches))
            check(launched == per_call and unpacked == unpack_expected(
                unpack_cuda, 1), f"read_batch launches {launched} "
                f"{unpacked}, expected {per_call} and one unpack")
            launches = {k: launches[k] + launched[k] for k in launches}
            check(tuple(got.shape) == (B, F, 1), f"read_batch shape "
                  f"{tuple(got.shape)}")
            got = got.cpu()
            check(torch.equal(got, plain.read_batch(files, starts, F)),
                  f"read_batch {files} {starts}: card differs from the "
                  "plain route")
            for j, (f, s) in enumerate(zip(files, starts)):
                want = np.zeros((F, 1), np.int16)
                seg = host.read(f, s, F)
                want[: len(seg)] = seg
                padded += len(seg) < F
                check(np.array_equal(got[j].numpy(), want),
                      f"read_batch crop {j} (clip {f}, frame {s}): card "
                      "differs from backend='host'")
    check(padded >= 2, f"only {padded} crops padded")
    print(f"phase 5: read_batch: {READ_BATCHES} batches of {B} crops of {F} "
          f"frames over {len(clips)} 7/16 clips ({padded} padded) equal to "
          f"the plain route and to backend='host'; launches {launches}, "
          "one unpack a batch")
    (row,) = bench_torch.unpack_rows(
        torch, [("read_batch", "read_batch", wires[0])],
        {"read_batch": {"unpack": READ_BATCHES}}, card)
    check((row["B"], row["nb"]) == (B, 8), f"read_batch unpacked "
          f"[{row['B']}, {row['nb']}]")
    print(f"phase 5: {row['name']}, {row['wire_bytes']} wire bytes: kernel "
          f"{row['ms']:.6f} ms ({row['cold_l2_ms']:.6f} ms with L2 flushed), "
          f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}), {row['bound_share']:.1%} of bound {card}")
    return {"launches": launches | {"unpack": READ_BATCHES}, "row": row}


def phase5_cli(synth_cuda) -> dict:
    """acmtool -d -r -o in process on the card, equal to the goldens."""
    from libacm_tpu_torch import cli
    from libacm_tpu_torch.ops import kernels, unpack_cuda

    os.environ.pop("LIBACM_TPU_TORCH_DEVICE", None)  # the card
    kernels.reset_all()
    with tempfile.TemporaryDirectory() as tmp:
        for name in CLI_FIXTURES:
            src = ROOT / "tests" / "fixtures" / f"{name}.acm"
            out = pathlib.Path(tmp) / f"{name}.raw"
            so, se = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
                rc = cli.main(["-d", "-r", "-o", str(out), str(src)])
            gold = ROOT / "tests" / "goldens"
            check(rc == 0, f"acmtool -d {name} exited {rc}: {se.getvalue()}")
            check(out.read_bytes() == (gold / f"{name}.raw").read_bytes(),
                  f"acmtool -d -r {name}: differs from the golden .raw")
            check(so.getvalue().replace(str(src), "%SRC%")
                  == (gold / f"{name}.info").read_text(),
                  f"acmtool -d {name}: info line differs from the golden")
    launches = dict(synth_cuda.launches)
    unpacked = dict(unpack_cuda.launches)
    print(f"phase 5: CLI: acmtool -d -r -o on {', '.join(CLI_FIXTURES)} "
          f"equal to the goldens; launches {launches} {unpacked}")
    check(sum(launches.values()) > 0, "the CLI launched no kernel")
    check(not any(unpacked.values()), f"the CLI (dense k) launched the "
          f"unpack: {unpacked}")
    return launches | unpacked


def phase5_kernel_times(torch, synth_cuda, synth_torch, dev, card) -> list:
    """The kernel at the shapes the stream and read_segment give it (one
    file per launch) and read_batch gives it, and at blocks that fit one
    CTA per SM or none,
    against its plain version; CUDA-event times (L2 warm, and flushed
    before each launch) beside the plain version's and the bound. Returns
    a JSON row (launches to be filled in) for each shape of the route of
    blocks over 227 KB, which no path of real files reaches."""
    out = []
    for what, level, rows, B, nb in [(w, lv, r, 1, n) for w, lv, r, n
                                     in NEW_SHAPES] + BATCH_SHAPES:
        k, v, w = _random_inputs(torch, dev, level, rows, B, nb,
                                 seed=level * 7 + nb)
        route = kernel_route(synth_cuda, level, rows, nb)
        got = synth_cuda.synth_pcm_batch(k, v, w, level=level, rows=rows)
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        err = _max_err(torch, got, want, level)
        check(err == 0, f"kernel disagrees at {level}/{rows} [{B}, {nb}]")
        ms = _time_ms(torch, lambda: synth_cuda.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=20)
        cold_ms = _time_ms_cold(torch, lambda: synth_cuda.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=20)
        plain_ms = _time_ms(torch, lambda: synth_torch.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=5)
        bms, by = bound(level, rows, B, nb)
        cfg = synth_cuda.fused_config(level, rows, B, nb, dev)
        shape = (f", tile {cfg['T']}, span {cfg['span']}, grid "
                 f"{cfg['grid']}, {cfg['ctas_per_sm']} CTAs per SM"
                 if cfg else "")
        print(f"phase 5: synthesis {what} {level}/{rows} [B={B}, nb={nb}] "
              f"{route}{shape}: kernel {ms} ms ({cold_ms} ms with L2 "
              f"flushed), plain {plain_ms} ms, bound {bms} ms ({by}), "
              f"{bms / ms:.1%} of bound, max abs err {err} {card}")
        if route.endswith("synth_tail"):
            out.append({
                "name": f"{route} ({what}, [{B}, {nb}])", "route": "cuda",
                "source": "libacm_tpu_torch/csrc/synth.cu",
                "replaces": "libacm_tpu/ops/synth_pallas.py:72",
                "launches": None, "max_abs_err": err, "ms": ms,
                "cold_l2_ms": cold_ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by, "library_ms": None,
                "shape": f"level {level}, rows {rows}, B {B}, nb {nb}",
                "launches_per_call": synth_cuda.kernel_launches(level, rows,
                                                                nb),
            })
        del k, v, w, got, want
    return out


class _ReadOnly:
    """A read()-only source (a pipe's shape): no seek, no length."""

    def __init__(self, data: bytes):
        self._b = io.BytesIO(data)

    def read(self, n: int = -1) -> bytes:
        return self._b.read(n)


def _stream_equal(pcm, meta, host, what: str) -> None:
    """decode_stream_device's result ≡ the host decoder's FileResult."""
    check(meta.status == host.status and meta.filler_words
          == host.filler_words,
          f"{what}: status/filler {(meta.status, meta.filler_words)} != host "
          f"{(host.status, host.filler_words)}")
    got = pcm.reshape(-1)[: len(host.pcm)].cpu().numpy()
    check(got.shape == host.pcm.shape and np.array_equal(got, host.pcm),
          f"{what}: PCM differs from the host decoder")


def stream_over_cards(torch, corpus, path, host, card) -> None:
    """The long stream with each window's blocks cut over every card:
    spans on their cards, in block order, equal to the host decoder."""
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    for W in STREAM_WINDOWS:
        for d in cards:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        spans, meta = corpus.decode_stream_device(path, devices=cards,
                                                  window_blocks=W)
        for d in cards:
            torch.cuda.synchronize(d)
        rate = len(host.pcm) / (time.perf_counter() - t0) / 1e6
        check(all(p.device == cards[i % len(cards)]
                  for i, p in enumerate(spans)),
              f"window {W}: a span does not lie on its card")
        _stream_equal(torch.cat([p.to(spans[0].device) for p in spans]), meta,
                      host, f"window {W} over {len(cards)} cards")
        print(f"phase 6: stream W={W} over {len(cards)} cards: "
              f"{len(spans)} spans equal to decode_corpus_host; {rate} "
              f"Msamples/s (host clock) {card}")


def phase6_stream(torch, synth_cuda, corpus, testing, dev, card, data,
                  t_build) -> dict:
    """The windowed stream at full width, on the long stream phase 1
    built. Returns the launches of the whole path and of one decode for
    each (level, rows, W) shape."""
    from libacm_tpu_torch.ops import kernels, unpack_cuda

    host = corpus.decode_corpus_host([data])[0]
    samples = len(host.pcm)
    check(host.status == 0 and host.filler_words == 0
          and samples == STREAM_BLOCKS * 2048,
          "phase 6: the long stream does not decode cleanly on the host")
    print(f"phase 6: long stream: {STREAM_BLOCKS} blocks, {samples} samples "
          f"({samples / 22050 / 60:.1f} min at 22,050 Hz), "
          f"{len(data) / 1e6:.1f} MB, built in {t_build:.1f} s (phase 1) "
          f"from {STREAM_DISTINCT} encoded blocks")
    path_launches = expected(synth_cuda, {}) | unpack_expected(unpack_cuda,
                                                               0)
    per_shape = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "long.acm"
        path.write_bytes(data)
        for W in STREAM_WINDOWS:
            n_win = -(-STREAM_BLOCKS // W)
            rates = []
            for kind in ("path", "read()-only"):
                src = path if kind == "path" else _ReadOnly(data)
                torch.cuda.synchronize()
                kernels.reset_all()
                t0 = time.perf_counter()
                pcm, meta = corpus.decode_stream_device(
                    src, device=dev, window_blocks=W)
                torch.cuda.synchronize()
                rates.append(samples / (time.perf_counter() - t0) / 1e6)
                launches = dict(synth_cuda.launches)
                check(launches == expected(synth_cuda, {"synth_fused": 1},
                                           n_win),
                      f"window {W} from a {kind}: launches {launches}, "
                      f"expected one fused launch for each of {n_win} "
                      "windows")
                check(dict(unpack_cuda.launches)
                      == unpack_expected(unpack_cuda, n_win),
                      f"window {W} from a {kind}: unpack launches "
                      f"{unpack_cuda.launches}, expected one unpack call "
                      f"for each of {n_win} windows")
                launches |= unpack_cuda.launches
                check(tuple(pcm.shape) == (n_win * W, 2048)
                      and pcm.device.type == "cuda",
                      f"window {W}: PCM {tuple(pcm.shape)} on {pcm.device}")
                _stream_equal(pcm, meta, host, f"window {W} from a {kind}")
                for r in path_launches:
                    path_launches[r] += launches[r]
                per_shape[(7, 16, W)] = launches
                del pcm
            print(f"phase 6: stream windows W={W}: {n_win} windows, one "
                  f"fused launch and one unpack launch each, "
                  f"from a path and a read()-only "
                  f"object equal to decode_corpus_host; {rates} Msamples/s "
                  f"(host clock, one decode each) {card}")
        # no copy from the card while the stream decodes: the carry stays
        out = []
        wall, ranked = _profiled(torch, lambda: out.append(
            corpus.decode_stream_device(path, device=dev,
                                        window_blocks=STREAM_WINDOWS[0])))
        print_breakdown(f"phase 6: stream W={STREAM_WINDOWS[0]}", wall,
                        ranked, card)
        fetched = [key for _, _, key in ranked if "DtoH" in key]
        check(not fetched, f"the windowed stream copied from the card: "
              f"{fetched}")
        # the copy, the unpack and the synthesis: no eager unpack
        n_win = -(-STREAM_BLOCKS // STREAM_WINDOWS[0])
        ops = sum(count for _, count, _ in ranked)
        print(f"phase 6: stream W={STREAM_WINDOWS[0]}: {ops} device "
              f"operations for {n_win} windows, {ops / n_win} a window, copy "
              "included")
        check(ops == 3 * n_win + 2,
              f"the windowed stream ran {ops} device operations for "
              f"{n_win} windows, not the copy, the unpack and the "
              "synthesis a window and one fill and one cat a decode")
        print("phase 6: no device-to-host copy in the profiled windowed "
              "decode: the carry was never fetched")
        _stream_equal(*out[-1], host, "profiled windowed decode")
        del out
        host_breakdown(torch, lambda: corpus.decode_stream_device(
            path, device=dev, window_blocks=STREAM_WINDOWS[0]),
            f"phase 6: stream W={STREAM_WINDOWS[0]}")
        kernels.reset_all()
        t0 = time.perf_counter()
        pcm, meta = corpus.decode_stream_device(path, device=dev)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        check(dict(synth_cuda.launches)
              == expected(synth_cuda, {"synth_fused": 1})
              and dict(unpack_cuda.launches)
              == unpack_expected(unpack_cuda, 1),
              f"full-file stream: launches {synth_cuda.launches} "
              f"{unpack_cuda.launches}")
        _stream_equal(pcm, meta, host, "full-file stream")
        print(f"phase 6: full-file call (one window of {STREAM_BLOCKS} "
              f"blocks) equal to both: {samples / t_full / 1e6} Msamples/s "
              f"{card}")
        del pcm
        if torch.cuda.device_count() > 1:
            stream_over_cards(torch, corpus, path, host, card)

    rng = np.random.default_rng(8)
    for what, level, rows, nb, W in PASS_STREAMS:
        d = testing.speech_acm_bytes(rng, level=level, rows=rows,
                                     n_blocks=nb)
        h = corpus.decode_corpus_host([d])[0]
        kernels.reset_all()
        pcm, meta = corpus.decode_stream_device(_ReadOnly(d), device=dev,
                                                window_blocks=W)
        torch.cuda.synchronize()
        launches = dict(synth_cuda.launches)
        n_win = -(-nb // W)
        per_window = synth_cuda.kernel_launches(level, rows, W)
        check(sum(per_window.values()) == 1
              and launches == expected(synth_cuda, per_window, n_win)
              and dict(unpack_cuda.launches)
              == unpack_expected(unpack_cuda, n_win),
              f"{what} stream: launches {launches} {unpack_cuda.launches}, "
              f"expected {per_window} and one unpack call for each of "
              f"{n_win} windows")
        launches |= unpack_cuda.launches
        _stream_equal(pcm, meta, h, f"{what} stream")
        print(f"phase 6: {what} stream {level}/{rows} x {nb} blocks, "
              f"W={W}: equal to decode_corpus_host; launches {launches}, "
              "one a window")
        for r in path_launches:
            path_launches[r] += launches[r]
        per_shape[(level, rows, W)] = launches

    stale = (ROOT / "tests" / "fixtures"
             / "stale_table_fuzz_2103.acm").read_bytes()
    h = corpus.decode_corpus_host([stale])[0]
    for W in (None, 2):
        pcm, meta = corpus.decode_stream_device(stale, device=dev,
                                                window_blocks=W)
        check(pcm.device.type == "cuda", "stale stream: PCM not on the card")
        _stream_equal(pcm, meta, h, f"stale-amp-table stream W={W}")
    try:
        corpus.decode_stream_device(_ReadOnly(stale), device=dev,
                                    window_blocks=2)
    except ValueError as exc:
        check("stale-amp-table" in str(exc), f"unexpected ValueError: {exc}")
    else:
        raise SmokeFailure("a stale-amp-table stream from a read()-only "
                           "source did not raise ValueError")
    print("phase 6: stale-amp-table stream: host fallback equal to "
          "decode_corpus_host (full-file and windowed); ValueError from a "
          "read()-only source")
    return {"launches": path_launches, "per_shape": per_shape}


def phase6_carry(torch, synth_cuda, synth_torch, dev) -> None:
    """One launch over [0, nb) ≡ two launches with wrapf handed over on
    the card ≡ the plain version: the non-zero wrap0 at B = 1 that the
    window path rests on."""
    for level, rows, nb, m in SPLITS:
        k, v, w = _random_inputs(torch, dev, level, rows, 1, nb,
                                 seed=level * 17 + m)
        whole = synth_cuda.synth_pcm_batch(k, v, w, level=level, rows=rows)
        a = synth_cuda.synth_pcm_batch(
            k[:, :m].contiguous(), v[:, :m].contiguous(), w, level=level,
            rows=rows)
        b = synth_cuda.synth_pcm_batch(
            k[:, m:].contiguous(), v[:, m:].contiguous(), a[1], level=level,
            rows=rows)
        torch.cuda.synchronize()
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        split = (torch.cat([a[0], b[0]], dim=1), b[1])
        err = max(_max_err(torch, whole, want, level),
                  _max_err(torch, split, want, level))
        print(f"phase 6: carry-in {level}/{rows} [1, {nb}] = [1, {m}] + "
              f"[1, {nb - m}]: max abs err {err} (tolerance 0)")
        check(err == 0, f"split launches disagree at {level}/{rows}")
        del k, v, w, whole, a, b, want, split


def largest_groups(synth_cuda, dc) -> dict:
    """For each kernel route, the (level, rows, B, nb) of the decoded
    corpus's group with the most samples."""
    largest: dict = {}
    for b in dc._buckets:
        B, nb = b.pcm.shape[0], b.pcm.shape[1]
        route = kernel_route(synth_cuda, b.level, b.rows, nb)
        if B * b.pcm[0].numel() > largest.get(route, (0,))[0]:
            largest[route] = (B * b.pcm[0].numel(), b.level, b.rows, B, nb)
    return {r: v[1:] for r, v in largest.items()}


def phase6_sharded(torch, synth_cuda, corpus, files, host, checksum3,
                   samples, card) -> dict:
    """Phase 3's corpus over a device list: one card named twice (the
    groups share a pool key: grouping, buffer holds, result order), and
    over every card where there are several. Returns the launches of the
    one-card-twice decode and, for each route, the (level, rows, B, nb)
    of its group with the most samples."""
    def check_results(dc, what):
        check(dc.block_until_ready().checksum() == checksum3,
              f"{what}: checksum {dc.checksum():#010x} != single-device "
              f"{checksum3:#010x}")
        for g, h in zip(dc.to_results(), host):
            check(g.index == h.index and g.status == h.status
                  and g.filler_words == h.filler_words,
                  f"{what}: file {h.index} status/filler differs")
            check((g.pcm is None) == (h.pcm is None)
                  and (h.pcm is None or np.array_equal(g.pcm, h.pcm)),
                  f"{what}: file {h.index} PCM differs from the host decode")

    from libacm_tpu_torch.ops import checksum_cuda, kernels, unpack_cuda

    twice = [torch.device("cuda", 0)] * 2
    kernels.reset_all()
    dc = corpus.decode_corpus_device(files, devices=twice)
    dc.block_until_ready().checksum()
    launches = dict(synth_cuda.launches)
    # one device (named twice): one checksum launch over its groups
    check(dict(checksum_cuda.launches) == {"checksum": 1},
          f"devices=[cuda:0, cuda:0]: checksum launches "
          f"{checksum_cuda.launches}, not one a device")
    launches |= checksum_cuda.launches
    check(dict(unpack_cuda.launches)
          == unpack_expected(unpack_cuda, len(dc._buckets)),
          f"devices=[cuda:0, cuda:0]: unpack launches {unpack_cuda.launches} "
          f"for {len(dc._buckets)} groups")
    launches |= unpack_cuda.launches
    check_results(dc, "devices=[cuda:0, cuda:0]")
    print(f"phase 6: sharded corpus over [cuda:0, cuda:0]: "
          f"{len(dc._buckets)} groups, checksum {checksum3:#010x} equal to "
          f"the single-device one, {len(files)} files equal to "
          f"decode_corpus_host; launches {launches}")
    for kernel in CORPUS_KERNELS:
        check(launches[kernel] > 0,
              f"the sharded corpus launched {kernel} no time")
    shapes = largest_groups(synth_cuda, dc)
    del dc
    n_cards = torch.cuda.device_count()
    print(f"phase 6: cards: {n_cards}")
    if n_cards > 1:
        every = [torch.device("cuda", i) for i in range(n_cards)]
        dc = corpus.decode_corpus_device(files, devices=every)
        check_results(dc, f"devices over {n_cards} cards")
        used = {b.pcm.device.index for b in dc._buckets}
        check(used == set(range(n_cards)), f"cards used: {sorted(used)}")
        print(f"phase 6: sharded corpus over {n_cards} distinct cards: "
              "checksum and results equal")
        del dc
        # one card against the lists, in turns (a machine with one card
        # has nothing to compare: the bench times the single device)
        lists = {"[cuda:0, cuda:0]": twice, f"{n_cards} cards": every}
        runs: dict[str, list[float]] = {}
        for what in ["single"] + list(lists) * 2 + ["single"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kw = ({"device": "cuda"} if what == "single"
                  else {"devices": lists[what]})
            corpus.decode_corpus_device(files, **kw).block_until_ready()
            runs.setdefault(what, []).append(
                samples / (time.perf_counter() - t0) / 1e6)
        print(f"phase 6: corpus decode {samples} samples, in turns: {runs} "
              f"Msamples/s (host clock) {card}")
    else:
        print("phase 6: one card: decode over distinct cards not verified")
    return {"launches": launches, "shapes": shapes}


def phase6_processes(files, summary3, checksum3) -> dict:
    """Two ranks, each joining over gloo, decoding its manifest shard on
    the card and all-reducing the summary; totals equal to phase 3's.
    Returns the ranks' launches, added up."""
    import socket

    worker = ROOT / "tests" / "_torch_dist_worker.py"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ)
    env.pop("LIBACM_TPU_TORCH_DEVICE", None)  # the card
    with tempfile.TemporaryDirectory() as tmp:
        for i, data in enumerate(files):
            (pathlib.Path(tmp) / f"f{i:03d}.acm").write_bytes(data)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(worker), coord, "2", str(r), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(2)]
        outs = []
        try:
            deadline = time.monotonic() + 300
            for r, p in enumerate(procs):
                try:
                    out, err = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise SmokeFailure(f"rank {r} timed out") from None
                check(p.returncode == 0,
                      f"rank {r} exited {p.returncode}: {err[-2000:]}")
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0

    def line(out, tag):
        for ln in out.splitlines():
            if ln.startswith(tag + " "):
                return json.loads(ln[len(tag) + 1:])
        raise SmokeFailure(f"a rank printed no {tag} line")

    totals = line(outs[0], "RESULT")
    shards = [line(o, "SHARD") for o in outs]
    for key in ("n_files", "n_ok", "n_failed", "n_partial", "samples"):
        check(totals[key] == getattr(summary3, key),
              f"two processes: {key} {totals[key]} != one process "
              f"{getattr(summary3, key)}")
    check([s["files"] for s in shards]
          == [(len(files) + 1) // 2, len(files) // 2],
          f"two processes: shard sizes {[s['files'] for s in shards]}")
    check(sum(s["checksum"] for s in shards) & 0xFFFFFFFF == checksum3,
          "two processes: shard checksums do not add up to one process's")
    launches = {k: 0 for k in shards[0]["launches"]}
    for s in shards:
        check(s["device"].startswith("cuda"),
              f"a rank decoded on {s['device']}, not on the card")
        for kernel in launches:
            launches[kernel] += s["launches"][kernel]
    check(all(launches[k] for k in CORPUS_KERNELS + (UNPACK_ROUTE,)),
          f"two processes: launches {launches}: a kernel ran no time")
    check(launches["checksum"] == 2,
          f"two processes: checksum launches {launches['checksum']}, not "
          "one a rank")
    print(f"phase 6: two processes over gloo: shards "
          f"{[s['files'] for s in shards]} files on "
          f"{[s['device'] for s in shards]}, totals equal to one process "
          f"({totals['samples']} samples), checksums add up; launches "
          f"{launches}; {wall:.1f} s with start-up")
    return launches


def path_kernel_rows(torch, synth_cuda, synth_torch, dev, card,
                     st6, sh6, dense7) -> list:
    """The kernel at the shapes phase 6's and phase 7's paths give it — a
    stream window, [1, W] with a non-zero carry-in, and each route's
    largest group of the sharded corpus and of the dense route — against
    its plain version: time beside the plain version's and the bound. One
    JSON row per shape; a window's launches are those of one decode of
    that stream, a group's those of the whole decode on its path."""
    shapes = [("stream window", 7, 16, 1, W,
               st6["per_shape"][(7, 16, W)]) for W in STREAM_WINDOWS]
    shapes += [(f"stream window, {what}", level, rows, 1, W,
                st6["per_shape"][(level, rows, W)])
               for what, level, rows, _, W in PASS_STREAMS]
    shapes += [("sharded corpus, largest group", *geom, sh6["launches"])
               for geom in sh6["shapes"].values()]
    shapes += [("dense route pack=False, largest group", *geom,
                dense7["launches"]) for geom in dense7["shapes"].values()]
    rows_out = []
    for what, level, rows, B, W, launches in shapes:
        k, v, w = _random_inputs(torch, dev, level, rows, B, W,
                                 seed=level * 5 + W)
        route = kernel_route(synth_cuda, level, rows, W)
        got = synth_cuda.synth_pcm_batch(k, v, w, level=level, rows=rows)
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        err = _max_err(torch, got, want, level)
        check(err == 0, f"kernel disagrees at {level}/{rows} [{B}, {W}]")
        del got, want
        ms = _time_ms(torch, lambda: synth_cuda.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=20)
        cold_ms = _time_ms_cold(torch, lambda: synth_cuda.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=20)
        plain_ms = _time_ms(torch, lambda: synth_torch.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=5)
        bms, by = bound(level, rows, B, W)
        cfg = synth_cuda.fused_config(level, rows, B, W, dev)
        shape = (f", tile {cfg['T']}, span {cfg['span']}, grid "
                 f"{cfg['grid']}" if cfg else "")
        print(f"kernel rows: synthesis {what} {level}/{rows} [B={B}, nb={W}], "
              f"non-zero carry-in, {route}{shape}: kernel {ms} ms "
              f"({cold_ms} ms with L2 flushed), plain {plain_ms} ms, bound "
              f"{bms} ms ({by}), {bms / ms:.1%} of bound, max abs err {err} "
              f"{card}")
        rows_out.append({
            "name": f"{route} ({what}, [{B}, {W}])", "route": "cuda",
            "source": "libacm_tpu_torch/csrc/synth.cu",
            "replaces": "libacm_tpu/ops/synth_pallas.py:72",
            "launches": route_launches(synth_cuda, launches, level, rows, W),
            "max_abs_err": err, "ms": ms, "cold_l2_ms": cold_ms,
            "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "shape": f"level {level}, rows {rows}, B {B}, nb {W}",
        })
        del k, v, w
    return rows_out


def phase7_dense(torch, synth_cuda, corpus, native, testing, files,
                 card) -> dict:
    """The dense device route (_dispatch_dense) on the card, both forms,
    each with the launch counters reset just before and read just after.

    pack=False: dense int16 k goes to the card and straight into the
    kernel; over the first two files of every bench-mix class and the five
    hostile ones, at full size. pack=True without the scanner: the Python
    oracle scans (slow, so short files: every class at a twentieth of its
    length, two seeds), blocks are packed by width class for the copy and
    unpacked on the card (unpack_blocks: one kernel launch a chunk). PCM,
    status and filler equal to decode_corpus_host, checksum() equal to
    the host sum and to the cols-wire route's (one checksum launch), both
    synthesis routes launched. Returns each decode's launches (the
    checksum's included) and the pack=False decode's largest group per
    route."""
    from libacm_tpu_torch.ops import kernels

    firsts = np.cumsum([0] + [m[1] for m in MIX])[:-1]
    full = [files[i + j] for i in firsts for j in (0, 1)] + files[-5:]
    short = make_corpus(testing, 0.05, seed=7) + make_corpus(testing, 0.05,
                                                             seed=8)
    out = {}
    for what, subset, kw in (("pack=False", full, {"pack": False}),
                             ("pack=True without the scanner", short, {})):
        host = corpus.decode_corpus_host(subset)
        cols = corpus.decode_corpus_device(subset, device="cuda")
        check(len(cols._buckets) > 0 and cols.summary.scan_s > 0,
              "phase 7: the cols-wire route did not run")
        scanner = native.available
        if not kw:
            native.available = lambda: False  # for this call only
        try:
            kernels.reset_all()
            t0 = time.perf_counter()
            dc = corpus.decode_corpus_device(subset, device="cuda", **kw)
            dc.block_until_ready()
            wall = time.perf_counter() - t0
            dc.checksum()
            launches = kernels.all_launches()
        finally:
            native.available = scanner
        check(launches["checksum"] == 1
              and launches["unpack_blocks"] == (0 if kw else len(dc._buckets)),
              f"phase 7: {what}: checksum and unpack_blocks launches "
              f"{launches} for {len(dc._buckets)} chunks")
        check(dc.summary.scan_s == 0,
              f"phase 7: {what} took the cols-wire route")
        check_corpus(native, subset, dc, host)
        check(dc.checksum() == cols.checksum(),
              f"phase 7: {what}: checksum {dc.checksum():#010x} != the "
              f"cols-wire route's {cols.checksum():#010x}")
        for kernel in CORPUS_KERNELS:
            check(launches[kernel] > 0, f"phase 7: the dense route ({what}) "
                  f"launched {kernel} no time")
        print(f"phase 7: dense route, {what}: {len(subset)} files "
              f"({dc.summary.samples} samples, every class) equal to "
              f"decode_corpus_host, checksum {dc.checksum():#010x} equal to "
              f"the cols-wire route's; launches {launches}; {wall:.3f} s "
              f"{card}")
        out["launches" if kw else "packed_launches"] = launches
        out.setdefault("shapes", largest_groups(synth_cuda, dc))
        del dc, cols
    return out


def phase7_kernels(torch, native, corpus, files, dev, card,
                   checksum_launches: int, packed_launches: int) -> list:
    """The checksum and block-unpack kernels at the bench's shapes, each
    held to its plain version (a mismatch fails), timed with the L2 warm
    and flushed beside its bound, its device operations counted under the
    profiler (bench_torch.checksum_row, unpack_blocks_row): checksum()
    over the whole corpus's PCM (10 chunks, one launch, exactly three
    operations: the span table's copy, the launch, the scalar's fetch;
    torch.sum over the same tensors as its library yardstick), and
    unpack_blocks on the mix's first 25 speech files packed as the dense
    route packs a chunk (7/16, 7,500 blocks; exactly one operation: the
    launch, no fill).
    Returns the two JSON rows, with the launches of the paths that ran
    them (phase 3's corpus; phase 7's dense route with pack=True)."""
    dc = corpus.decode_corpus_device(files, device="cuda")
    dc.block_until_ready()
    (pcms, ngs), = corpus._checksum_inputs(dc._buckets).values()
    ck = bench_torch.checksum_row(torch, pcms, ngs, checksum_launches, card)
    # bench_torch.profiled's guard keeps the profiler from losing the
    # first activities of its window, so the count is exact
    check(ck["call_ops"] == 3, f"phase 7: checksum() made {ck['call_ops']} "
          "device operations on one device, not 3 (the table's copy, the "
          "launch, the scalar's fetch)")
    print(f"phase 7: checksum kernel over {ck['words']} PCM words in "
          f"{ck['chunks']} chunks ({ck['spans']} spans, {ck['tiles']} tiles), "
          f"equal to its plain version: kernel {ck['ms']:.6f} ms "
          f"({ck['cold_l2_ms']:.6f} ms with L2 flushed); checksum() device "
          f"{ck['call_ms']:.6f} ms in {ck['call_ops']} operations (wall "
          f"{ck['call_wall_ms']:.3f} ms); plain {ck['plain_ms']:.6f} ms in "
          f"{ck['plain_ops']} operations (wall {ck['plain_wall_ms']:.3f} ms);"
          f" torch.sum {ck['library_ms']:.6f} ms; bound {ck['bound_ms']:.6f} "
          f"ms ({ck['bound_by']}), {ck['bound_share']:.1%} of bound {card}")
    del dc, pcms
    ub = bench_torch.unpack_blocks_row(
        torch, bench_torch.packed_chunk(native, files), dev,
        "dense_route_packed", packed_launches, card)
    check(ub["call_ops"] == 1, f"phase 7: unpack_blocks made "
          f"{ub['call_ops']} device operations, not 1 (the launch)")
    print(f"phase 7: unpack_blocks kernel 7/16 [{ub['blocks']} blocks], "
          f"{ub['packed_bytes']} packed bytes ({ub['padding_rows']} padding "
          f"rows), equal to its plain version: "
          f"{ub['ms']:.6f} ms ({ub['cold_l2_ms']:.6f} ms with L2 flushed) in "
          f"{ub['call_ops']} device operations, plain {ub['plain_ms']:.6f} ms,"
          f" bound {ub['bound_ms']:.6f} ms ({ub['bound_by']}), "
          f"{ub['bound_share']:.1%} of bound {card}")
    return [ck, ub]


def _all_finite(x) -> bool:
    if isinstance(x, dict):
        return all(_all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_all_finite(v) for v in x)
    if isinstance(x, float):
        return np.isfinite(x)
    return True


def phase7_bench(files, stream, checksum3) -> dict:
    """bench_torch.py in process on the card, on phase 3's files and phase
    6's stream, three rounds a group: every card field present, non-null
    and finite, no group skipped, checksums equal to phase 3's, parity
    PASS. Prints the bench's line; returns it."""
    art = bench_torch.run_bench("cuda", 3, 1.0, files=files, stream=stream)
    missing = [f for f in bench_torch.CARD_FIELDS if art.get(f) is None]
    check(not missing, f"phase 7: bench fields null or missing: {missing}")
    check(_all_finite(art), "phase 7: the bench's line holds a non-finite "
          "number")
    check(not art["budget_skipped"] and not art["rehearsal"]
          and art["device"]["platform"] == "gpu",
          f"phase 7: bench skipped {art['budget_skipped']} or did not run "
          "on the card")
    check(art["device_checksum"] == f"{checksum3:#010x}"
          and art["device_checksums_equal"] is True,
          f"phase 7: bench checksum {art['device_checksum']} != phase 3's "
          f"{checksum3:#010x}")
    check(art["parity_sweep"] == "PASS",
          f"phase 7: parity sweep {art['parity_sweep']!r}")
    for row in art["kernel_rows"]:
        check(row["max_abs_err"] == 0 and row["launches"] > 0,
              f"phase 7: bench kernel row {row['name']}: err "
              f"{row['max_abs_err']}, launches {row['launches']}")
    print(json.dumps(art, allow_nan=False))
    return art


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import (checksum_cuda, kernels, synth_cuda,
                                      synth_torch, unpack_cuda)
    from libacm_tpu_torch.parallel import build_index, corpus
    from libacm_tpu_torch.scan import native

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    t_phase = [t_all]

    def phase_done(what: str) -> None:
        now = time.perf_counter()
        print(f"{what}: {now - t_phase[0]:.1f} s (at {now - t_all:.1f} s)")
        t_phase[0] = now

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
    # the corpus and phase 6's long stream are encoded (pure Python and
    # numpy) while the compilers run in their own processes
    encoded: list = []

    def encode() -> None:
        files = make_corpus(testing)
        t_files = time.perf_counter()
        stream = long_stream(testing, build_index, STREAM_SEED,
                             STREAM_BLOCKS, STREAM_DISTINCT)
        encoded.append((files, t_files, stream,
                        time.perf_counter() - t_files))

    enc = threading.Thread(target=encode)
    t0 = time.perf_counter()
    th.start()
    enc.start()
    built = kernels.build_all()  # one nvcc per CUDA source, all at once
    th.join()
    t_builds = time.perf_counter() - t0
    check(scanner_ok == [True], "the port's C++ scanner did not build")
    print("phase 1: built "
          + ", ".join(f"{so.name} (nvcc {t:.1f} s)"
                      for so, _, t in built.values())
          + f" and the scanner ({t_builds:.1f} s for all)")
    for line in "".join(r for _, r, _ in built.values()).splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    phase_done("phase 1")

    # -- 2. kernel parity ---------------------------------------------------
    # per kernel: the largest error, geometries and launches
    parity_err = expected(synth_cuda, {})
    parity_n = expected(synth_cuda, {})
    parity_launches = expected(synth_cuda, {})
    for level, rows, B, nb in PARITY:
        k, v, w = _random_inputs(torch, dev, level, rows, B, nb,
                                 seed=level * 131 + rows)
        route = kernel_route(synth_cuda, level, rows, nb)
        kernels.reset_all()
        got = synth_cuda.synth_pcm_batch(k, v, w, level=level, rows=rows)
        torch.cuda.synchronize()
        launched = dict(synth_cuda.launches)
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        err = _max_err(torch, got, want, level)
        check(launched == expected(synth_cuda, synth_cuda.kernel_launches(
            level, rows, nb)), f"{level}/{rows}: launches {launched}")
        for kernel, n in launched.items():
            if n:
                parity_err[kernel] = max(parity_err[kernel], err)
                parity_n[kernel] += 1
                parity_launches[kernel] += n
        print(f"phase 2: {level}/{rows} B={B} nb={nb} {route}: max abs err "
              f"{err} (tolerance 0)")
        check(err == 0, f"kernel disagrees with plain at {level}/{rows}")
    check(all(parity_n.values()), f"a kernel was not exercised: {parity_n}")
    # the unpack kernel: the synthetic edges and random wires now, the
    # wires of the corpus, a stream window and random access once encoded
    unpack_n = unpack_parity(torch, unpack_cuda, synth_torch, "edges", [
        {**w, "blob": torch.from_numpy(w["blob"]).to(dev)}
        for w in map(edge_wire, UNPACK_EDGES)])
    unpack_n += unpack_parity(torch, unpack_cuda, synth_torch, "random", [
        {**w, "blob": torch.from_numpy(w["blob"]).to(dev)}
        for w in map(random_wire, UNPACK_RANDOM)])
    print(f"phase 2: unpack: {len(UNPACK_EDGES)} synthetic edges and "
          f"{len(UNPACK_RANDOM)} random wires equal to the plain version "
          f"(tolerance 0), {unpack_n} launches")
    unpack_race(torch, unpack_cuda, synth_torch, dev)
    enc.join()
    check(len(encoded) == 1, "the corpus was not encoded")
    files, t_enc, stream_data, t_stream = encoded[0]
    path_wires = phase2_path_wires(torch, corpus, files, stream_data)
    for what, wires in path_wires.items():
        n = unpack_parity(torch, unpack_cuda, synth_torch, what, wires)
        unpack_n += n
        print(f"phase 2: unpack: {len(wires)} {what} wires equal to the "
              f"plain version (tolerance 0), {n} launches")

    phase_done("phase 2")

    # -- 3. main path at real size ------------------------------------------
    print(f"phase 3: encoded {len(files)} files "
          f"({sum(map(len, files)) / 1e6:.1f} MB) in {t_enc - t0:.1f} s, "
          f"and the long stream in {t_stream:.1f} s, beside the builds")
    # the main path: the decode and its checksum, as the bench times them
    kernels.reset_all()
    t0 = time.perf_counter()
    dc = corpus.decode_corpus_device(files, device="cuda")
    dc.block_until_ready()
    t_first = time.perf_counter() - t0
    checksum3 = dc.checksum()
    main_launches = dict(synth_cuda.launches)
    main_unpack = dict(unpack_cuda.launches)
    main_checksum = dict(checksum_cuda.launches)
    samples = dc.summary.samples
    shapes = sorted({(b.level, b.rows, b.pcm.shape[0], b.pcm.shape[1])
                     for b in dc._buckets})
    print(f"phase 3: decode_corpus_device: {samples} samples, "
          f"{len(dc._buckets)} chunks, launches {main_launches} "
          f"{main_unpack} {main_checksum}, first run {t_first:.3f} s {card}")
    # one checksum launch over every chunk of the one device
    check(main_checksum == {"checksum": 1},
          f"main path: checksum launches {main_checksum}, not one")
    main_kernels = path_kernels(synth_cuda, [(lv, rw, nb) for lv, rw, _, nb
                                             in shapes])
    check(main_kernels == set(CORPUS_KERNELS),
          f"main path's shapes route to {sorted(main_kernels)}")
    for name_, n_ in main_launches.items():
        check((n_ > 0) == (name_ in main_kernels),
              f"main path launched {name_} {n_} times")
    # one unpack launch a chunk, beside its synthesis launch
    check(main_unpack == unpack_expected(unpack_cuda, len(dc._buckets))
          and sum(main_launches.values()) == len(dc._buckets),
          f"main path: unpack launches {main_unpack} for "
          f"{len(dc._buckets)} chunks")
    t0 = time.perf_counter()
    host = corpus.decode_corpus_host(files, workers=os.cpu_count() or 1)
    t_host = time.perf_counter() - t0
    print(f"phase 3: decode_corpus_host ({os.cpu_count()} threads) "
          f"{samples / t_host / 1e6} Msamples/s (host clock)")
    n_checked = check_corpus(native, files, dc, host)
    summary3 = dc.summary
    print(f"phase 3: {n_checked} files equal to decode_corpus_host; "
          f"checksum {checksum3:#010x} equal to the host sum")
    del dc
    phase_done("phase 3")

    # -- 4. numbers ---------------------------------------------------------
    # one profiled decode; the repeated end-to-end rounds are the bench's
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
        route = kernel_route(synth_cuda, level, rows, nb)
        got = synth_cuda.synth_pcm_batch(k, v, w, level=level, rows=rows)
        want = synth_torch.synth_pcm_batch(k, v, w, level=level, rows=rows)
        err = _max_err(torch, got, want, level)
        check(err == 0, f"kernel disagrees at main-path shape {level}/{rows}")
        del got, want
        ms = _time_ms(torch, lambda: synth_cuda.synth_pcm_batch(
            k, v, w, level=level, rows=rows), reps=20)
        cold_ms = _time_ms_cold(torch, lambda: synth_cuda.synth_pcm_batch(
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
              f"{route}: kernel {ms:.6f} ms ({cold_ms:.6f} ms with L2 "
              f"flushed), plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}), "
              f"{bms / ms:.1%} of bound ({bms / cold_ms:.1%} flushed) "
              f"{card}")
        kern_rows.setdefault(route, {
            "name": route, "route": "cuda",
            "source": "libacm_tpu_torch/csrc/synth.cu",
            "replaces": "libacm_tpu/ops/synth_pallas.py:72",
            "launches": main_launches[route],
            "max_abs_err": max(err, parity_err[route]),
            "ms": ms, "cold_l2_ms": cold_ms, "plain_ms": plain_ms,
            "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "smem_bytes": cfg["smem_bytes"],
            "ctas_per_sm": cfg["ctas_per_sm"],
            "shape": f"level {level}, rows {rows}, B {B}, nb {nb}",
            "parity": f"bit-equal on {parity_n[route]} geometries",
        })
        del k, v, w
    check(set(kern_rows) == main_kernels,
          "a kernel of the main path has no shape to time")
    # the unpack at each corpus geometry's largest chunk (the first, with
    # the most samples, is its row of the main path), a stream window and
    # random-access segments of 8 and 32 blocks, on the wires of phase 2
    unpack_at = unpack_shapes(path_wires, STREAM_WINDOWS[0])
    unpack_rows = bench_torch.unpack_rows(torch, unpack_at,
                                          {"corpus": main_unpack}, card)
    smoke_path = {"corpus": "corpus", "random_access": "random_access",
                  f"stream_window_{STREAM_WINDOWS[0]}": "stream_windows"}
    for (_, path, _), r in zip(unpack_at, unpack_rows):
        r["path"] = smoke_path[path]  # the bench's path, by the smoke's name
        print(f"phase 4: {r['name']}, {r['wire_bytes']} wire bytes: kernel "
              f"{r['ms']:.6f} ms ({r['cold_l2_ms']:.6f} ms with L2 flushed), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), {r['bound_share']:.1%} of bound {card}")
    kern_rows[UNPACK_ROUTE] = dict(
        unpack_rows.pop(0), name=UNPACK_ROUTE,
        parity=f"bit-equal on {unpack_n} wires")
    unpack_path_rows = [r for r in unpack_rows if r["path"] != "corpus"]
    unpack_rows = [r for r in unpack_rows if r["path"] == "corpus"]
    del path_wires

    phase_done("phase 4")

    # -- 5. reference API on the card ---------------------------------------
    mix_files = mix_class_firsts(files) + [files[-5]]  # + a bit-flipped one
    paths = {"corpus": main_launches | main_unpack | main_checksum}
    paths["stream"] = phase5_stream(torch, synth_cuda, mix_files, card)
    paths["random_access"] = phase5_random_access(torch, synth_cuda, files,
                                                   card)
    rb5 = phase5_read_batch(torch, synth_cuda, testing, card)
    paths["read_batch"] = rb5["launches"]
    paths["cli"] = phase5_cli(synth_cuda)
    rows5 = phase5_kernel_times(torch, synth_cuda, synth_torch, dev, card)
    for row in rows5:  # the route that no path of real files reaches
        row["launches"] = sum(parity_launches[k]
                              for k in row["launches_per_call"])
        row["launches_by_path"] = {"parity": {
            k: parity_launches[k] for k in row["launches_per_call"]}}
    phase_done("phase 5")

    # -- 6. device lists, windows, processes --------------------------------
    st6 = phase6_stream(torch, synth_cuda, corpus, testing, "cuda", card,
                        stream_data, t_stream)
    paths["stream_windows"] = st6["launches"]
    phase6_carry(torch, synth_cuda, synth_torch, dev)
    sh6 = phase6_sharded(torch, synth_cuda, corpus, files, host, checksum3,
                         samples, card)
    paths["sharded_corpus"] = sh6["launches"]
    paths["two_processes"] = phase6_processes(files, summary3, checksum3)
    phase_done("phase 6")

    # -- 7. the dense route, and the bench in process -----------------------
    dense7 = phase7_dense(torch, synth_cuda, corpus, native, testing, files,
                          card)
    paths["dense_route"] = dense7["launches"]
    paths["dense_route_packed"] = dense7["packed_launches"]
    rows7 = phase7_kernels(torch, native, corpus, files, dev, card,
                           main_checksum["checksum"],
                           dense7["packed_launches"]["unpack_blocks"])
    phase_done("phase 7 (dense route, checksum and block unpack)")
    art = phase7_bench(files, stream_data, checksum3)
    paths["bench"] = {
        kernel: sum(n.get(kernel, 0) for n in art["device_launches"].values())
        for kernel in paths["corpus"] | dense7["packed_launches"]}
    phase_done("phase 7 (bench)")

    def by_path(route: str) -> dict:
        return {p: sum(n.get(k, 0) for k in route.split("+"))
                for p, n in paths.items()}

    for route, row in kern_rows.items():
        row["launches_by_path"] = by_path(route)
    for row in unpack_path_rows:
        p = row["path"]
        row["launches"] = by_path(UNPACK_ROUTE)[p]
        row["launches_by_path"] = {p: row["launches"]}
        check(row["launches"] > 0, f"{row['name']}: no unpack launch on {p}")
    for row in rows7:
        row["launches_by_path"] = {p: n for p, n in by_path(
            row["kernel"]).items() if n}
    rows67 = path_kernel_rows(torch, synth_cuda, synth_torch, dev, card,
                              st6, sh6, dense7)
    print(json.dumps({"kernels": [kern_rows[r] for r in sorted(kern_rows)]
                      + unpack_rows + unpack_path_rows + [rb5["row"]]
                      + rows7 + rows67 + rows5}))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
