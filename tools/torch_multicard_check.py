#!/usr/bin/env python3
"""Hold the port's device-list paths to the host decoder over several
distinct cards.

    python3 tools/torch_multicard_check.py

Needs at least two cards (exits 2 otherwise). chip_smoke.py on a one-card
machine can only name one card twice; this drives what exists only across
cards — one wire blob per card, kernels launched on a card that is not
the current one, the carry and the halo block copied card to card — and
nothing else: the entry file's dry run over every card, then, with
chip_smoke.py's own functions, the bench corpus mix sharded over every
card (checksum and every file against decode_corpus_host, Msamples/s
against one card in turns) and the long stream with its windows cut over
the cards. Prints the card's name and power limit first and
`MULTICARD OK` last.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_multicard_check: needs at least two cards",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import __graft_entry_torch__ as entry
    import chip_smoke as cs
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import synth_cuda
    from libacm_tpu_torch.parallel import build_index, corpus

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print("\n".join(ln.strip() for ln in smi))
    card = f"[{len(smi)} x {smi[0].strip()}]"
    synth_cuda.build()
    entry.dryrun_multidevice()
    print(f"dryrun_multidevice OK over {torch.cuda.device_count()} cards")

    files = cs.make_corpus(testing)
    host = corpus.decode_corpus_host(files)
    one = corpus.decode_corpus_device(files, device="cuda:0")
    cs.phase6_sharded(torch, synth_cuda, corpus, files, host,
                      one.block_until_ready().checksum(),
                      one.summary.samples, card)
    data = cs.long_stream(testing, build_index, 6, cs.STREAM_BLOCKS,
                          cs.STREAM_DISTINCT)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "long.acm"
        path.write_bytes(data)
        cs.stream_over_cards(torch, corpus, path,
                             corpus.decode_corpus_host([data])[0], card)
    print("MULTICARD OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
