"""Batch-transcode a directory of ACM/WAVC files to WAV (PyTorch port).

    python examples/torch_transcode_corpus.py IN_DIR OUT_DIR
        [--force-stereo] [--device DEVICE]

Equivalent to running the reference's `acmtool -d` per file, but decodes
the whole corpus in batched dispatches on the card and reports summary
throughput. `--device` names the torch device (default: the card, or
$LIBACM_TPU_TORCH_DEVICE; without a card and without either this fails).
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from libacm_tpu_torch import ingest
from libacm_tpu_torch.parallel import CorpusConfig


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("in_dir", type=pathlib.Path)
    ap.add_argument("out_dir")
    ap.add_argument("--force-stereo", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    # content sniffing, not extension matching: game archives hide ACM
    # payloads under arbitrary suffixes (the players' typefind analog)
    paths = ingest.walk_acm(args.in_dir)
    t0 = time.perf_counter()
    results = ingest.decode_to_wav_dir(
        paths, args.out_dir, device=args.device,
        config=CorpusConfig(force_chans=2 if args.force_stereo else 0))
    dt = time.perf_counter() - t0
    ok = sum(r.ok for r in results)
    samples = sum(len(r.pcm) for r in results if r.pcm is not None)
    print(f"{ok}/{len(paths)} files ok, {samples/1e6:.1f} Msamples "
          f"in {dt:.2f}s = {samples/dt/1e6:.1f} Msamples/s")
    for r in results:
        if not r.ok:
            print(f"  {paths[r.index].name}: status {r.status}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
