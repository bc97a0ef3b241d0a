"""libacm_tpu_torch — InterPlay ACM/WAVC decode on PyTorch and CUDA.

The PyTorch/CUDA port of `libacm_tpu`, which stays beside it as the
reference the port is held to bit for bit. The port imports torch, never
jax, and nothing of `libacm_tpu`: the host layers it needs are its own
copies.

Layers:
  - `format`   — on-disk format model + error taxonomy (copy)
  - `io`       — pluggable host IO, WAV writer, header patcher (copy)
  - `scan`     — serial bitstream front-end: C++ scanner + NumPy oracle (copy)
  - `testing`  — fixture encoder (copy)
  - `ops`      — synthesis: plain torch ops (`synth_torch`), the cols-wire
                 unpack (`packing`) and the hand-written CUDA kernel
                 (`synth_cuda`, source in `csrc/synth.cu`)
  - `stream`   — reference-compatible streaming API (open/read/seek/info)
  - `parallel` — batched corpus decode with PCM left on the device (one
                 device or files sharded over a list), one stream decoded
                 in windows with its carry kept on the device
                 (`decode_stream_device`), multi-process sharding on
                 torch.distributed (`parallel.distributed`), and
                 O(segment) random access
  - `device`   — `resolve_device`, `resolve_devices`, `make_mesh`: where
                 entry points run
  - `cli`      — the acmtool command-line tool
  - `encode`   — the encoder (numpy, or float32 torch on the device)
  - `ingest`   — corpus iterators and jobs for data pipelines

Entry points run on the card unless the caller asks for another device:
`device=None` resolves to $LIBACM_TPU_TORCH_DEVICE (for example `cpu`)
when that is set, else to CUDA, and raises without a card (`device`).
"""

from .format import (
    ACM_ID,
    ACM_WORD,
    ACMInfo,
    AcmError,
    AcmException,
    AcmHeader,
    acm_strerror,
    is_acm,
    sniff,
    sniff_bytes,
)
from .stream import (
    AcmStream,
    DecodeState,
    acm_bitrate,
    acm_channels,
    acm_close,
    acm_info,
    acm_open_decoder,
    acm_open_file,
    acm_pcm_tell,
    acm_pcm_total,
    acm_rate,
    acm_raw_tell,
    acm_raw_total,
    acm_read,
    acm_read_loop,
    acm_seek_pcm,
    acm_seek_time,
    acm_seekable,
    acm_time_tell,
    acm_time_total,
)

__version__ = "0.1"

__all__ = [
    "ACM_ID",
    "ACM_WORD",
    "ACMInfo",
    "AcmError",
    "AcmException",
    "AcmHeader",
    "AcmStream",
    "DecodeState",
    "acm_strerror",
    "is_acm",
    "sniff",
    "sniff_bytes",
    "acm_open_decoder",
    "acm_open_file",
    "acm_read",
    "acm_read_loop",
    "acm_close",
    "acm_info",
    "acm_seekable",
    "acm_rate",
    "acm_channels",
    "acm_bitrate",
    "acm_pcm_tell",
    "acm_pcm_total",
    "acm_time_tell",
    "acm_time_total",
    "acm_raw_tell",
    "acm_raw_total",
    "acm_seek_pcm",
    "acm_seek_time",
]
