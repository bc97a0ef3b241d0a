"""Batched corpus decode (data-parallel over files) on one torch device,
and O(segment) random access."""

from .corpus import (
    CorpusConfig,
    CorpusSummary,
    DeviceCorpus,
    FileResult,
    decode_corpus,
    decode_corpus_device,
    decode_corpus_host,
    effective_stop,
)
from .random_access import (BlockIndex, RandomAccessCorpus, build_index,
                            read_segment)

__all__ = [
    "BlockIndex",
    "CorpusConfig",
    "CorpusSummary",
    "DeviceCorpus",
    "FileResult",
    "build_index",
    "decode_corpus",
    "decode_corpus_device",
    "decode_corpus_host",
    "effective_stop",
    "RandomAccessCorpus",
    "read_segment",
]
