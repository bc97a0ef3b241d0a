"""Bounded-memory streaming consumption of one ACM file (PyTorch port).

    python examples/torch_stream_player.py FILE [seek_seconds]
        [--device DEVICE]

Two consumers of one read()-only handle (no length, no mmap):

- the windowed AcmStream, the reference's plugin/player usage shape: at
  most `window_blocks` decoded blocks stay resident on the host, and the
  output is byte-identical to a full-file decode;
- decode_stream_device in windows of the same size: each window's wire is
  copied to the device as soon as it is scanned, the filterbank carry goes
  from window to window on the device, and the PCM stays there. Its sum is
  held against the streamed bytes.

`--device` names the torch device (default: the card, or
$LIBACM_TPU_TORCH_DEVICE).
"""

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from libacm_tpu_torch.device import resolve_device
from libacm_tpu_torch.parallel import decode_stream_device
from libacm_tpu_torch.stream import AcmStream, acm_open_file

WINDOW_BLOCKS = 8


class FileReader:
    """Deliberately minimal AcmIO: read() only (a pipe/VFS stand-in)."""

    def __init__(self, path):
        self._f = open(path, "rb")

    def read(self, size: int = -1) -> bytes:
        return self._f.read(size)

    def close(self) -> None:
        self._f.close()


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file")
    ap.add_argument("seek_seconds", nargs="?", type=float)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # fails here without a card
    path = args.file
    src = FileReader(path)
    s = AcmStream(src, window_blocks=WINDOW_BLOCKS)
    print(f"{path}: {s.channels} ch @ {s.rate} Hz, "
          f"level {s.info.acm_level}/rows {s.info.acm_rows}, "
          f"{s.time_total() / 1000:.1f} s")

    t0 = time.perf_counter()
    out = bytearray()
    peak = 0
    while True:
        chunk = s.read_loop(8192)  # "play" 8 KiB at a time
        if not chunk:
            break
        out += chunk
        peak = max(peak, s._win.resident_bytes())
    dt = time.perf_counter() - t0
    src.close()
    total = len(out)
    print(f"streamed {total / 2 / 1e6:.2f} Msamples in {dt:.2f}s "
          f"({total / 2 / dt / 1e6:.1f} Msamples/s), "
          f"peak window residency {peak / 1024:.0f} KiB")

    # the same stream, windowed, onto the device: the PCM stays there
    src = FileReader(path)
    t0 = time.perf_counter()
    pcm, meta = decode_stream_device(src, device=device,
                                     window_blocks=WINDOW_BLOCKS)
    n = total // 2
    dev_sum = int(pcm.reshape(-1)[:n].sum(dtype=torch.int64))
    dt = time.perf_counter() - t0
    src.close()
    want = int(np.frombuffer(bytes(out), "<i2").astype(np.int64).sum())
    if dev_sum != want or meta.status != 0:
        print(f"device stream differs: sum {dev_sum} != {want}, status "
              f"{meta.status}")
        return 1
    print(f"device stream: {tuple(pcm.shape)} int16 on {pcm.device} in "
          f"{dt:.2f}s, sum equal to the streamed bytes")

    if args.seek_seconds is not None:
        # interactive-seek shape: reopen seekably and jump around
        s2 = acm_open_file(path, window_blocks=WINDOW_BLOCKS, device=device)
        ms = int(args.seek_seconds * 1000)
        reached = s2.seek_time(ms)
        print(f"seek to {ms} ms -> reached {reached} ms; "
              f"next chunk: {len(s2.read_loop(8192))} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
