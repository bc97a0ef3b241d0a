"""Dataset-ingest adapters — the rebuild's answer to the player plugins.

The reference ships four player plugins (xmms2/audacious/gstreamer/winamp,
the C reference's `plugins/`) whose real content is: custom IO injection,
streaming decode, and interactive seek on top of the core API. Modern
consumers of this framework are data pipelines, so the equivalents are
iterator/ingest adapters over corpora (the custom-IO use case itself is
covered by the `AcmIO` duck-typed protocol in `libacm_tpu_torch.io`,
and interactive streaming + seek by `AcmStream`).

The port of libacm_tpu/ingest.py, over the port's `decode_corpus`: every
adapter decodes on `device` (None: the card, or $LIBACM_TPU_TORCH_DEVICE;
see device.resolve_device) and hands PCM to the host per file.
"""

from __future__ import annotations

import os
import pathlib
from typing import Iterator, Sequence

import numpy as np

from . import io as acmio
from .format import sniff
from .parallel.corpus import CorpusConfig, FileResult, decode_corpus


def walk_acm(root: str | os.PathLike) -> list[pathlib.Path]:
    """All ACM/WAVC files under `root`, found by CONTENT, not extension.

    The typefind analog for directory ingest (the reference's players
    register magic-based detection, plugin-gstreamer.c:159-170,
    plugin-xmms2.c:239-247): game archives commonly ship ACM payloads
    under arbitrary extensions. Unreadable entries are skipped. Results
    are sorted for a deterministic manifest.
    """
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            p = pathlib.Path(dirpath) / fn
            try:
                acm, wavc = sniff(p)
            except OSError:
                continue
            if acm or wavc:
                out.append(p)
    return sorted(out)


def iter_pcm(
    sources: Sequence,
    *,
    batch_files: int = 64,
    config: CorpusConfig | None = None,
    device=None,
) -> Iterator[FileResult]:
    """Stream per-file decode results over an arbitrarily large corpus.

    Decodes `batch_files` files per device dispatch round, yielding
    results in manifest order; memory stays O(batch), not O(corpus).
    Failed files yield their FileResult (status != 0) like decode_corpus.
    """
    cfg = config or CorpusConfig()
    batch_files = max(1, batch_files)
    for lo in range(0, len(sources), batch_files):
        for r in decode_corpus(sources[lo : lo + batch_files], config=cfg,
                               device=device):
            # decode_corpus indexes within its chunk; re-anchor to the
            # caller's manifest so file_index survives batching
            r.index += lo
            yield r


def iter_frames(
    sources: Sequence,
    frame_samples: int,
    *,
    hop: int | None = None,
    pad_value: int = 0,
    batch_files: int = 64,
    config: CorpusConfig | None = None,
    device=None,
) -> Iterator[tuple[int, np.ndarray]]:
    """Fixed-size training frames from a corpus: (file_index, int16 frame).

    Frames are per-file windows of `frame_samples` interleaved words with
    stride `hop` (default: no overlap); the final partial window is padded
    with `pad_value`. Files that failed to open are skipped.
    """
    hop = hop or frame_samples
    for r in iter_pcm(sources, batch_files=batch_files, config=config,
                      device=device):
        if r.pcm is None or len(r.pcm) == 0:
            continue
        pcm = r.pcm
        for lo in range(0, len(pcm), hop):
            w = pcm[lo : lo + frame_samples]
            if len(w) < frame_samples:
                w = np.concatenate([
                    w, np.full(frame_samples - len(w), pad_value, np.int16)
                ])
            yield r.index, w
            if lo + frame_samples >= len(pcm):
                break


def torch_frame_dataset(sources, frame_samples: int, **kw):
    """`torch.utils.data.IterableDataset` of (file_index, int16 frame).

    A thin adapter over `iter_frames` for torch-based training loops (the
    reference's player plugins fed audio players; the modern consumer is
    a data pipeline). Files are sharded across DataLoader workers, so
    `num_workers > 1` does not duplicate frames — yielded indices always
    refer to the caller's manifest.

    Worker processes decode through the pure-host native pipeline: a
    forked child must not initialize CUDA (the parent may already own the
    card), so with `num_workers > 0` the native scanner is required —
    workers raise a clear error when it is unavailable rather than
    fork-initializing the card. Pass an explicit `config` to override (at
    your own risk).

    >>> ds = torch_frame_dataset(paths, frame_samples=4096)
    >>> loader = torch.utils.data.DataLoader(ds, batch_size=32)
    """
    import torch
    import torch.utils.data as tud

    srcs_all = list(sources)

    class _Dataset(tud.IterableDataset):
        def __iter__(self):
            info = tud.get_worker_info()
            lo, stride = (0, 1) if info is None else (info.id,
                                                      info.num_workers)
            wkw = kw
            if info is not None and "config" not in kw:
                from .scan import native

                if not native.available():
                    raise RuntimeError(
                        "torch_frame_dataset with num_workers > 0 needs "
                        "the native scanner (forked workers must not "
                        "initialize CUDA); pass config= to override")
                wkw = {**kw, "config": CorpusConfig(backend="host"),
                       "device": None}
            shard = srcs_all[lo::stride]  # srcs_all[lo + i*stride]
            for i, frame in iter_frames(shard, frame_samples, **wkw):
                yield lo + i * stride, torch.from_numpy(frame)

    return _Dataset()


def decode_to_wav_dir(
    sources: Sequence[str | os.PathLike],
    out_dir: str | os.PathLike,
    *,
    config: CorpusConfig | None = None,
    batch_files: int = 64,
    device=None,
) -> list[FileResult]:
    """Batch-transcode a corpus to WAV files (batched `acmtool -d`).

    Output names mirror the inputs with a .wav suffix; decode errors are
    reported in the returned results, with partial files written zero-padded
    to the declared length exactly like the CLI (acmtool.c:293-310).
    """
    out_path = pathlib.Path(out_dir)
    out_path.mkdir(parents=True, exist_ok=True)
    results = []
    srcs = list(sources)
    for lo in range(0, len(srcs), max(1, batch_files)):
        chunk = srcs[lo : lo + batch_files]
        for src, r in zip(chunk, decode_corpus(chunk, config=config,
                                               device=device)):
            r.index += lo  # re-anchor chunk-relative index to the manifest
            results.append(r)
            if r.pcm is None:
                continue
            info = r.info
            total = (r.info and len(r.pcm) + r.filler_words) or 0
            wav = out_path / (pathlib.Path(src).stem + ".wav")
            with open(wav, "wb") as f:
                f.write(acmio.wav_header(total // info.channels,
                                         info.channels, info.rate))
                f.write(r.pcm.astype("<i2").tobytes())
                if r.filler_words:
                    f.write(bytes(2 * r.filler_words))
    return results


def run_corpus_job(
    sources: Sequence,
    checkpoint_path: str | os.PathLike,
    *,
    batch_files: int = 64,
    config: CorpusConfig | None = None,
    on_result=None,
    device=None,
):
    """Resumable corpus decode job (SURVEY §5 checkpoint/resume).

    Decodes the manifest in `batch_files` batches, persisting the manifest
    CURSOR plus running counters to `checkpoint_path` (atomic JSON) after
    every batch; rerunning after a crash resumes at the last completed
    batch. `on_result(FileResult)` is invoked per file in manifest order
    — delivery is at-least-once per file across crashes (a batch that was
    in flight when the process died is redecoded), so side effects should
    be idempotent (e.g. keyed writes).

    Returns a dict summary: {"files", "n_ok", "n_failed", "n_partial",
    "samples", "resumed_at"}. The checkpoint file is left in place on
    completion (cursor == len(sources)) so reruns are no-ops.
    """
    import json

    batch_files = max(1, batch_files)
    cp = pathlib.Path(checkpoint_path)
    state = {"cursor": 0, "n_ok": 0, "n_failed": 0, "n_partial": 0,
             "samples": 0}
    try:
        prev = json.loads(cp.read_text())
        # schema-validate: a torn/foreign/hand-edited checkpoint must mean
        # "start from zero", never a crash (TypeError on a str cursor) or
        # a poisoned counter surfacing mid-job
        if (isinstance(prev, dict)
                and all(isinstance(prev.get(k), int) and prev[k] >= 0
                        for k in state)):
            state.update({k: prev[k] for k in state})
    except (OSError, ValueError):
        pass  # absent or corrupt checkpoint: start from zero
    resumed_at = min(int(state["cursor"]), len(sources))
    srcs = list(sources)
    for lo in range(resumed_at, len(srcs), batch_files):
        chunk = srcs[lo : lo + batch_files]
        for r in decode_corpus(chunk, config=config, device=device):
            r.index += lo
            if r.status != 0 and r.pcm is None:
                state["n_failed"] += 1
            elif r.status != 0:
                state["n_partial"] += 1
            else:
                state["n_ok"] += 1
            if r.pcm is not None:
                state["samples"] += int(len(r.pcm))
            if on_result is not None:
                on_result(r)
        state["cursor"] = lo + len(chunk)
        tmp = cp.with_suffix(cp.suffix + ".tmp")
        tmp.write_text(json.dumps(state))
        tmp.replace(cp)  # atomic: a crash never leaves a torn checkpoint
    return dict(state, files=len(srcs), resumed_at=resumed_at)
