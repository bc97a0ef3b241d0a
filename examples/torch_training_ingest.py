"""Feed an ACM corpus into a (mock) training loop on the card (PyTorch
port).

    python examples/torch_training_ingest.py DIR [--device DEVICE]
        [--devices N]

Shows the device-resident path: PCM never returns to the host; a toy
"feature" step consumes each chunk's tensor where it lies. `--device`
names the torch device (default: the card, or $LIBACM_TPU_TORCH_DEVICE);
`--devices N` shards the files over the first N cards instead (over the
named device N times when that is not a card).
"""

import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from libacm_tpu_torch.parallel import decode_corpus_device, make_mesh


def feature_step(pcm_i16: torch.Tensor) -> torch.Tensor:
    x = pcm_i16.to(torch.float32) / 32768.0
    return torch.mean(x * x)  # stand-in for a real model step


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", type=pathlib.Path)
    ap.add_argument("--device", default=None)
    ap.add_argument("--devices", type=int, default=None)
    args = ap.parse_args(argv)
    paths = [str(p) for p in sorted(args.dir.glob("*.acm"))]
    if args.devices is None:
        corpus = decode_corpus_device(paths, device=args.device)
    else:
        devs = ([args.device] * args.devices if args.device
                else make_mesh(args.devices))
        corpus = decode_corpus_device(paths, devices=devs)
    energies = []
    for indices, pcm in corpus.device_arrays():
        energies.append((indices, pcm.device, feature_step(pcm)))
    for indices, dev, e in energies:
        print(f"files {indices} on {dev}: mean energy {float(e):.6f}")
    print("summary:", corpus.summary.as_dict())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
