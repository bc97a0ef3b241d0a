"""The plain reference's answers for the files a run made."""

from __future__ import annotations

import numpy as np
import torch

from ..gen.pool import Corpus
from ..reference import decode as ref
from ..reference.format import resolve_channels


def expected(corpus: Corpus, device, dtype: torch.dtype = torch.int64,
             ) -> list[ref.Expected]:
    """ref.Expected of every file of the corpus, PCM on `device`. With
    dtype=torch.float32: the control (the same reference in float32)."""
    pools = {i: ref.scan_pool(p.data, p.n_blocks)
             for i, p in enumerate(corpus.pools)}
    scans = []
    for f in corpus.files:
        h = ref.file_header(f.data)
        ch = resolve_channels(h.channels, h.wavc_file, 0)
        scans.append(ref.scan_file(f.data, h, ch, f.ids, pools[f.cls],
                                   f.first_changed_bit))
    return ref.expected_files(scans, pools, [f.cls for f in corpus.files],
                              device, dtype)


def digest(exps: list[ref.Expected]) -> int:
    """DeviceCorpus.checksum()'s digest of the reference's PCM: the sum
    of every good block's samples, modulo 2^32."""
    total = sum(int(e.pcm.to(torch.int64).sum()) for e in exps)
    return total & 0xFFFFFFFF


def exact_words(e: ref.Expected) -> np.ndarray:
    return e.exact_pcm().cpu().numpy()
