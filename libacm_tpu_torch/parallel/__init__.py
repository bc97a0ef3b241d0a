"""Batched corpus decode (data-parallel over files) on one torch device or
sharded over a list of them, one stream decoded in windows on the device,
multi-process sharding, and O(segment) random access.

The JAX package also exports `resolve_device_backend` (and has
`measure_backend`): they have no counterpart here. The port never picks a
synthesis back-end by a measurement inside a call: the device picks the
route, the CUDA kernel on a card and its plain version on the CPU.
"""

from ..device import make_mesh
from . import distributed
from .corpus import (
    CorpusConfig,
    CorpusSummary,
    DeviceCorpus,
    FileResult,
    decode_corpus,
    decode_corpus_device,
    decode_corpus_host,
    decode_stream_device,
    effective_stop,
)
from .distributed import allreduce_summary, initialize, shard_manifest
from .random_access import (BlockIndex, RandomAccessCorpus, build_index,
                            read_segment)

__all__ = [
    "BlockIndex",
    "CorpusConfig",
    "CorpusSummary",
    "DeviceCorpus",
    "FileResult",
    "allreduce_summary",
    "build_index",
    "decode_corpus",
    "decode_corpus_device",
    "decode_corpus_host",
    "decode_stream_device",
    "distributed",
    "effective_stop",
    "initialize",
    "make_mesh",
    "RandomAccessCorpus",
    "read_segment",
    "shard_manifest",
]
