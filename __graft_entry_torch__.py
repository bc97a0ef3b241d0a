"""Entry points of the PyTorch/CUDA port: the flagship step and a dry run
over a device list.

Counterpart of `__graft_entry__.py`. The flagship "model" is the batched
synthesis program, here the kernel wrapper
`libacm_tpu_torch.ops.synth_cuda.synth_pcm_batch`: dequantize + log2(cols)
FIR filterbank passes + rounding bias + arithmetic shift + int16, over a
[files, blocks, rows, cols] coefficient tensor — the hand-written CUDA
kernel for tensors on a card, its plain torch version for CPU tensors.

    python __graft_entry_torch__.py [DEVICE ...]

runs entry() on the first device and the dry run over the list (default:
every card). Without a card and without arguments it fails; `cpu cpu cpu`
runs the same legs over three CPU shards.
"""

import sys

import numpy as np
import torch

# Flagship shape: the classic Fallout speech geometry — level 7 (cols=128),
# rows 16 ⇒ 2048-word blocks.
_LEVEL, _ROWS = 7, 16


def _example(batch: int, nblocks: int, level: int = _LEVEL,
             rows: int = _ROWS):
    cols = 1 << level
    rng = np.random.default_rng(0)
    k = rng.integers(-1024, 1024,
                     size=(batch, nblocks, rows, cols)).astype(np.int16)
    vals = rng.integers(0, 1 << 16, size=(batch, nblocks)).astype(np.int32)
    wrap0 = np.zeros((batch, 2 * cols - 2), dtype=np.int32)
    return k, vals, wrap0


def entry():
    """(fn, example_args): the batched forward decode step at 7/16. The
    arguments are numpy arrays; move them to the device the step should
    run on (`torch.from_numpy(a).to(device)`)."""
    from libacm_tpu_torch.ops.synth_cuda import synth_pcm_batch

    def fwd(k, vals, wrap0):
        return synth_pcm_batch(k, vals, wrap0, level=_LEVEL, rows=_ROWS)

    return fwd, _example(batch=4, nblocks=8)


def dryrun_multidevice(devices=None) -> None:
    """Run the port's multi-device pipeline over a device list.

    `devices` is a list of torch devices (strings allowed, a device may
    repeat); None is every card. A CUDA device without a card raises: the
    dry run never reports a skipped leg as passed. Three legs, each
    cross-checked bit for bit:
      1. the flagship batched step with its files split over the devices,
         against the same step on the first device alone;
      2. `decode_corpus_device(devices=...)` — the production serving
         path — on a mixed synthesized corpus (two bucket geometries, a
         truncated member, a non-ACM member, a count the list does not
         divide), against `decode_corpus_host` and against a one-device
         run of the same pipeline;
      3. `decode_stream_device(devices=...)`, one stream's block axis cut
         over the list, full-file and windowed, against the host path.
    """
    from libacm_tpu_torch.device import make_mesh, resolve_devices
    from libacm_tpu_torch.ops.synth_cuda import synth_pcm_batch

    devs = make_mesh() if devices is None else resolve_devices(devices)
    n = len(devs)

    level, rows = 3, 8  # tiny shapes; the math is shape-generic
    k, vals, wrap0 = _example(2 * n, 4, level=level, rows=rows)

    def step(dev, lo, hi):
        args = (torch.from_numpy(a[lo:hi]).to(dev) for a in (k, vals, wrap0))
        pcm, _ = synth_pcm_batch(*args, level=level, rows=rows)
        return pcm

    parts = [step(dev, 2 * s, 2 * s + 2) for s, dev in enumerate(devs)]
    got = np.concatenate([p.cpu().numpy() for p in parts])
    want = step(devs[0], 0, 2 * n).cpu().numpy()
    np.testing.assert_array_equal(got, want, err_msg="batched step")

    _dryrun_production_pipeline(devs)


def _dryrun_production_pipeline(devs) -> None:
    """decode_corpus_device / decode_stream_device over `devs`: native
    packed scan → one cols-wire blob per device group → unpack + synthesis
    on that device → FileResult assembly; then the block-sharded single
    stream. Every PCM word, status and filler count is compared with the
    host path and with a one-device run of the same device pipeline."""
    from libacm_tpu_torch.parallel.corpus import (decode_corpus_device,
                                                  decode_corpus_host,
                                                  decode_stream_device)
    from libacm_tpu_torch.scan import native
    from libacm_tpu_torch.testing import random_acm_bytes

    if not native.available():
        raise RuntimeError(
            "native scanner unavailable: the production cols-wire path "
            "cannot be exercised")

    rng = np.random.default_rng(2026)
    corpus: list[bytes] = []
    for _ in range(5):
        corpus.append(random_acm_bytes(rng, level=7, rows=16, n_blocks=3,
                                       max_pwr=14))
    for _ in range(4):
        corpus.append(random_acm_bytes(rng, level=3, rows=16, n_blocks=4,
                                       max_pwr=12))
    corpus.append(corpus[0][: len(corpus[0]) // 2])
    corpus.append(b"not an ACM stream")

    host = decode_corpus_host(corpus)

    def check(results, tag):
        if len(results) != len(host):
            raise AssertionError(f"{tag}: {len(results)} results")
        for h, d in zip(host, results):
            if (h.status, h.filler_words) != (d.status, d.filler_words):
                raise AssertionError(
                    f"{tag}: file {h.index}: status/filler "
                    f"{(d.status, d.filler_words)} != "
                    f"{(h.status, h.filler_words)}")
            if (h.pcm is None) != (d.pcm is None):
                raise AssertionError(f"{tag}: file {h.index}: PCM presence")
            if h.pcm is not None:
                np.testing.assert_array_equal(h.pcm, d.pcm, err_msg=tag)

    sharded = decode_corpus_device(corpus, devices=devs, chunk_files=2)
    check(sharded.to_results(), "corpus-devices")
    single = decode_corpus_device(corpus, device=devs[0], chunk_files=2)
    check(single.to_results(), "corpus-single-device")
    if sharded.checksum() != single.checksum():
        raise AssertionError("corpus checksum differs over the device list")

    # Leg 3: one stream's block axis cut over every device.
    h0 = host[0]
    for window in (None, 2):
        pcm, meta = decode_stream_device(corpus[0], devices=devs,
                                         window_blocks=window)
        spans = pcm if isinstance(pcm, list) else [pcm]
        got = np.concatenate([p.cpu().numpy().reshape(-1) for p in spans])
        if (meta.status, meta.filler_words) != (h0.status, h0.filler_words):
            raise AssertionError("stream-blocks status")
        np.testing.assert_array_equal(got[: h0.pcm.size], h0.pcm,
                                      err_msg="stream-blocks pcm")


def main(argv) -> int:
    from libacm_tpu_torch.device import make_mesh, resolve_devices

    devs = resolve_devices(argv) if argv else make_mesh()
    fn, args = entry()
    out = fn(*(torch.from_numpy(a).to(devs[0]) for a in args))
    if devs[0].type == "cuda":
        torch.cuda.synchronize(devs[0])
    print("entry OK", [tuple(x.shape) for x in out], "on", devs[0])
    dryrun_multidevice(devs)
    print(f"dryrun_multidevice OK over {[str(d) for d in devs]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
