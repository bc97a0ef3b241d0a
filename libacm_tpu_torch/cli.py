"""acmtool — command-line tool, flag- and output-compatible with the
reference CLI (the C reference's `src/acmtool.c`).

Commands: -d decode to WAV/raw, -i info, -M/-S in-place channel retag,
-p play. Switches: -m/-s force channels, -r raw, -q quiet, -n no output
(benchmark mode), -o outfile, -v version. Info lines, stderr messages, WAV
bytes and zero-padding semantics match the reference so golden tests can
byte-compare outputs.

The port of libacm_tpu/cli.py, over the port's stream: run it as
`python -m libacm_tpu_torch.cli`. Decode and play synthesize on the card
unless LIBACM_TPU_TORCH_DEVICE names another device (for example `cpu`);
without a card and without that setting they exit non-zero before
touching a file.
"""

from __future__ import annotations

import getopt
import os
import sys

from . import io as acmio
from .device import resolve_device
from .format import (ACM_WORD, AcmException, acm_strerror, cli_total_bytes,
                     LIBACM_TPU_VERSION)
from .stream import AcmStream, acm_open_file

VERSION_LINE = f"acmtool - libacm_tpu version {LIBACM_TPU_VERSION}"


class _Config:
    raw = False
    force_chans = 0
    no_output = False
    quiet = False


def show_header(fn: str, acm: AcmStream, cf: _Config, out=None) -> None:
    """Info line, format identical to acmtool.c:39-54."""
    if cf.quiet:
        return
    out = out or sys.stdout
    kbps = acm.bitrate() // 1000
    tmp = acm.time_total() // 1000
    m, s = tmp // 60, tmp % 60
    print(
        f"{fn}: Length:{m:2d}:{s:02d} Chans:{acm.channels}({acm.info.acm_channels}) "
        f"Freq:{acm.rate} A:{acm.info.acm_level}/{acm.info.acm_rows} kbps:{kbps}",
        file=out,
    )


def _makefn(fn: str, ext: str) -> str:
    """Replace from the last dot (makefn, acmtool.c:164-174)."""
    base, dot, _ = fn.rpartition(".")
    return (base if dot else fn) + ext


#: files above this size decode through the bounded-memory windowed
#: stream with the reference's exact 8 KiB read pattern (O(window) RSS)
#: instead of the whole-file fast path
_WINDOWED_DECODE_BYTES = 32 << 20


def decode_file(fn: str, fn2: str, cf: _Config) -> None:
    """acmtool -d (acmtool.c:231-316): decode + WAV header + zero-pad tail."""
    try:
        huge = os.path.getsize(fn) > _WINDOWED_DECODE_BYTES
    except OSError:
        huge = False
    try:
        acm = acm_open_file(fn, cf.force_chans,
                            window_blocks=16 if huge else None)
    except AcmException as e:
        print(f"{fn}: {acm_strerror(e.code)}", file=sys.stderr)
        return

    fo = None
    fo_owned = False
    if not cf.no_output:
        if fn2 == "-":
            fo = sys.stdout.buffer
            cf.quiet = True
        else:
            fo_owned = True
            try:
                fo = open(fn2, "wb")
            except OSError as e:
                print(f"{fn2}: {e.strerror}", file=sys.stderr)
                acm.close()
                return

    show_header(fn, acm, cf)

    if not cf.raw and not cf.no_output:
        fo.write(acmio.wav_header(acm.pcm_total(), acm.channels, acm.rate))

    buflen = 16 * 1024
    # The reference reads 8 KiB chunks (acmtool.c:273-276) and its chunk
    # size is observable ONLY through error streams (an error surfacing at
    # a chunk boundary stops the CLI; mid-chunk it is swallowed). For a
    # clean stream every chunk size yields identical bytes, so read big
    # and keep the Python loop off the hot path. Huge files stream through
    # a windowed AcmStream instead — there the reference's own 8 KiB
    # pattern is used verbatim (identical semantics on EVERY stream, no
    # full-file error pre-scan, O(window) memory).
    if acm._win is not None:
        chunk = buflen // 2
    else:
        chunk = buflen // 2 if acm.has_errors() else 4 << 20
    # C int arithmetic: a hostile header claiming ~2^30+ samples wraps this
    # negative and the reference emits nothing past the WAV header
    # (acmtool.c:272) — without the wrap a ~100-byte file would make us
    # write gigabytes of zero filler.
    total_bytes = cli_total_bytes(acm.total_values, acm.channels)
    bytes_done = 0
    while bytes_done < total_bytes:
        try:
            buf = acm.read_loop(chunk)
        except AcmException as e:
            print(f"{fn}: {acm_strerror(e.code)}", file=sys.stderr)
            break
        if not buf:
            break
        if not cf.no_output:
            fo.write(buf)
        bytes_done += len(buf)

    if bytes_done < total_bytes:
        print(f"{fn}: adding filler_samples: {total_bytes - bytes_done}",
              file=sys.stderr)
        zeros = bytes(buflen)
        while bytes_done < total_bytes:
            bs = min(buflen, total_bytes - bytes_done)
            if not cf.no_output:
                fo.write(zeros[:bs])
            bytes_done += bs

    acm.close()
    if fo is not None and fo_owned:
        fo.close()


def show_info(fn: str, cf: _Config) -> None:
    try:
        # -i reads the header and decodes nothing: open as a stream that
        # needs no device, so that info works without a card
        acm = AcmStream(acmio.FileSource(fn), cf.force_chans,
                        synth_backend="host")
    except AcmException as e:
        print(f"{fn}: {acm_strerror(e.code)}")
        return
    show_header(fn, acm, cf)
    acm.close()


def set_channels_cmd(fn: str, n_chan: int) -> None:
    try:
        acmio.set_channels(fn, n_chan)
    except AcmException as e:
        detail = str(e).split(": ", 1)[-1]
        print(f"{fn}: {detail}", file=sys.stderr)
    except OSError as e:
        print(f"{fn}: {e.strerror}", file=sys.stderr)


def play_file(fn: str, cf: _Config) -> None:
    """acmtool -p. Uses the `sounddevice` package when present; the
    reference equivalently gates playback on libao (acmtool.c:472-482)."""
    try:
        import sounddevice  # type: ignore
    except ImportError:
        print("For audio output, please install the 'sounddevice' package.",
              file=sys.stderr)
        raise SystemExit(1)

    try:
        # windowed stream: sound starts after ONE decoded window and the
        # whole play stays O(window) memory, like the reference's lazy
        # per-block pipeline (acmtool.c:96-156); falls back to full-file
        # decode if the native scanner is unavailable
        acm = acm_open_file(fn, cf.force_chans, window_blocks=8)
    except AcmException as e:
        print(f"{fn}: {acm_strerror(e.code)}", file=sys.stderr)
        return
    show_header(fn, acm, cf)
    # Progressive playback, chunked like the reference's 4 KiB ao_play loop
    # (acmtool.c:118-128): decode/play interleave, O(chunk) memory. The
    # reference's total_bytes here is an *unsigned* int (acmtool.c:103), so
    # a hostile header wraps to a small positive count, not negative.
    buflen = 4 * 1024
    total = cli_total_bytes(acm.total_values, acm.channels, signed=False)
    done = 0
    stream = sounddevice.RawOutputStream(
        samplerate=acm.rate, channels=acm.channels, dtype="int16")
    with stream:
        while done < total:
            try:
                buf = acm.read_loop(buflen // ACM_WORD)
            except AcmException as e:
                print(f"{fn}: {acm_strerror(e.code)}", file=sys.stderr)
                break
            if not buf:
                break
            stream.write(buf)
            done += len(buf)
        if done < total:
            print(f"{fn}: adding filler_samples: {total - done}",
                  file=sys.stderr)
        zeros = bytes(buflen)
        while done < total:
            bs = min(buflen, total - done)
            stream.write(zeros[:bs])
            done += bs
    acm.close()


def encode_file(fn: str, fn2: str, cf: _Config) -> None:
    """acmtool -e (extension; the reference tool is decode-only):
    WAV (PCM16) → ACM via the global ridge analysis encoder."""
    from . import encode as acmenc

    try:
        channels, rate, pcm = acmio.read_wav(open(fn, "rb").read())
    except (OSError, ValueError) as e:
        print(f"{fn}: {e}", file=sys.stderr)
        return
    res = acmenc.encode_pcm(pcm, channels=channels, rate=rate, pwr=13)
    with open(fn2, "wb") as fo:
        fo.write(res.data)
    if not cf.quiet:
        ratio = pcm.nbytes / max(len(res.data), 1)
        print(f"{fn}: {len(pcm)//channels} samples -> {len(res.data)} bytes "
              f"({ratio:.1f}x), max_error {res.max_error}")


def usage(err: int) -> "SystemExit":
    print(VERSION_LINE)
    print("Play:   acmtool -p [-q][-m|-s] acmfile [acmfile ...]")
    print("Decode: acmtool -d [-q][-m|-s] [-r|-n] -o wavfile acmfile")
    print("        acmtool -d [-q][-m|-s] [-r|-n] acmfile [acmfile ...]")
    print("Other:  acmtool -i acmfile [acmfile ...]")
    print("        acmtool -M|-S acmfile [acmfile ...]")
    print("        acmtool -e [-o acmfile] wavfile [wavfile ...]")
    print("Commands:")
    print("  -p     play file(s)")
    print("  -d     decode audio into WAV files")
    print("  -i     show info about ACM files")
    print("  -M     modify ACM header to have 1 channel")
    print("  -S     modify ACM header to have 2 channels")
    print("  -e     encode WAV (PCM16) into ACM files")
    print("Switches:")
    print("  -m     force mono")
    print("  -s     force stereo")
    print("  -r     raw output - no wav header")
    print("  -q     be quiet")
    print("  -n     no output - for benchmarking")
    print("  -o FN  output to file, can be used if single source file")
    return SystemExit(err)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cf = _Config()
    cmd_decode = cmd_info = cmd_play = cmd_chg = cmd_enc = False
    set_chans = 0
    fn2 = None

    try:
        opts, args = getopt.getopt(argv, "pdieMSqhrmsnvo:")
    except getopt.GetoptError as e:
        print(f"bad arg: -{e.opt}", file=sys.stderr)
        raise usage(1)

    for flag, val in opts:
        if flag == "-h":
            raise usage(0)
        elif flag == "-d":
            cmd_decode = True
        elif flag == "-i":
            cmd_info = True
        elif flag == "-p":
            cmd_play = True
        elif flag == "-e":
            cmd_enc = True
        elif flag == "-M":
            cmd_chg, set_chans = True, 1
        elif flag == "-S":
            cmd_chg, set_chans = True, 2
        elif flag == "-q":
            cf.quiet = True
        elif flag == "-m":
            cf.force_chans = 1
        elif flag == "-s":
            cf.force_chans = 2
        elif flag == "-r":
            cf.raw = True
        elif flag == "-n":
            cf.no_output = True
        elif flag == "-o":
            fn2 = val
        elif flag == "-v":
            print(VERSION_LINE)
            return 0

    if sum([cmd_decode, cmd_info, cmd_play, cmd_chg, cmd_enc]) != 1:
        print("only one command at a time please", file=sys.stderr)
        raise usage(1)

    if cmd_enc:
        if not args:
            raise usage(1)
        if fn2 is not None:
            if len(args) != 1:
                raise usage(1)
            encode_file(args[0], fn2, cf)
        else:
            for fn in args:
                encode_file(fn, _makefn(fn, ".acm"), cf)
        return 0

    if cmd_play or cmd_decode:
        try:
            resolve_device()
        except RuntimeError as e:
            print(f"acmtool: {e}", file=sys.stderr)
            return 1

    if cmd_play:
        for fn in args:
            play_file(fn, cf)
        return 0

    if cmd_info:
        for fn in args:
            show_info(fn, cf)
        return 0

    if cmd_chg:
        for fn in args:
            set_channels_cmd(fn, set_chans)
        return 0

    # decode (LIBACM_TPU_TORCH_PROFILE=<dir> wraps the run in a profiler
    # trace)
    if not args:
        raise usage(1)
    from .utils.profiling import maybe_trace_from_env

    with maybe_trace_from_env():
        if fn2 is not None:
            if len(args) != 1:
                raise usage(1)
            decode_file(args[0], fn2, cf)
        else:
            for fn in args:
                decode_file(fn, _makefn(fn, ".raw" if cf.raw else ".wav"), cf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
