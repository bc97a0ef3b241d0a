"""Closed-loop training crops, one caller: HiFi-GAN's loader over the
configuration's clips, through `RandomAccessCorpus.read_batch`.

Set-up makes the clips in memory and opens one RandomAccessCorpus over
their bytes that caches every clip (a training job that holds its dataset
in memory: after its first epoch no clip is read from its source again),
builds every clip's index, reads `warm_batches` batches and takes the
memory of the `keep_batches` batches the window keeps into the
allocator's cache (kept batches that allocate afresh ran 15-20 % slower
on an H100 host than those after them). The window
then calls read_batch back to back for `--seconds`: each epoch a seeded
permutation of all clips, cut into batches of `batch` distinct clips
(drop_last; all the clips where there are fewer, as in a cut-down copy of
a cell), each crop `segment_frames` frames from a start drawn uniformly from
[0, frames - segment_frames] (0 for a clip shorter than a crop; the
program zero-pads past the clip's end). Each batch is consumed on the card
as a training step would read it: folded to an int64 sum of its words
times a fixed seeded int32 weight of each position. The first
`keep_batches` batches are kept whole. The window ends on a
synchronisation of the card; the rate is the samples of every crop
delivered in it over its time.

Check, once the window has closed: the kept batches crop by crop against
the plain reference's PCM of their clips, sliced and zero-padded by
HiFi-GAN's rule (crops_wrong), every batch's fold against the same fold of
the reference's crops (batch_folds_wrong), and the calls that raised
(crops_failed); limit 0 on each.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from ..gen.pool import Corpus, make_corpus
from ..harness import expect, roofline
from ..reference import decode as ref
from ..reference.format import resolve_channels

#: SeedSequence children of the run's seed
WEIGHT_STREAM, WARM_STREAM, WINDOW_STREAM = 6, 7, 8
#: folds kept on the card per buffer
FOLD_CHUNK = 16384
#: batches whose reference crops are folded together in the check
CHECK_BATCHES = 256
#: parts of the names of the device kernels the fold launches (the
#: product, the cast to int64, the sum, the zeroed fold buffers): the
#: consumer's work, which kernels.roofline_pct.crops leaves out
FOLD_KERNELS = ("MulFunctor", "direct_copy_kernel", "reduce_kernel",
                "FillFunctor")


@dataclasses.dataclass
class State:
    corpus: Corpus
    rac: object
    #: frames and channels of every clip
    frames: np.ndarray
    channels: int
    #: int32 [batch * segment_frames * channels] on the card
    weight: torch.Tensor
    #: crops a batch
    batch: int
    #: (files, starts) of every batch of the window, in order
    draws: list = dataclasses.field(default_factory=list)
    #: int64 buffers of the window's folds on the card
    folds: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)
    #: window batches whose call raised, and the errors
    failed: list = dataclasses.field(default_factory=list)
    errors: list = dataclasses.field(default_factory=list)
    wall_s: float = 0.0


def _rng(seed: int, child: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(seed).spawn(child + 1)[-1])


def batch_size(params: dict, n_clips: int) -> int:
    """Crops a batch: the mix's `batch`, or every clip where there are
    fewer."""
    return min(params["batch"], n_clips)


def batches(rng: np.random.Generator, frames: np.ndarray, batch: int,
            segment: int):
    """(files, starts) of each batch, without end: every epoch a new
    permutation of all clips in batches of `batch` (drop_last), each start
    uniform in [0, frames - segment], 0 where a clip is shorter."""
    n = len(frames)
    if not 0 < batch <= n:
        raise ValueError(f"{n} clips cannot fill a batch of {batch}")
    hi = np.maximum(frames - segment, 0)
    while True:
        perm = rng.permutation(n)
        starts = rng.integers(0, hi[perm] + 1)
        for k in range(n // batch):
            sl = slice(k * batch, (k + 1) * batch)
            yield perm[sl], starts[sl]


def fold_weight(seed: int, n: int, device) -> torch.Tensor:
    """The fixed int32 weight of each of a batch's n words, from the seed
    (a product with an int16 word fits int32)."""
    return torch.from_numpy(_rng(seed, WEIGHT_STREAM).integers(
        -32767, 32768, n, dtype=np.int32)).to(device)


def _fold_into(state: State, batch: torch.Tensor, i: int) -> None:
    """The batch's fold into slot i of the fold buffers, on its device."""
    if i // FOLD_CHUNK == len(state.folds):
        state.folds.append(torch.zeros(FOLD_CHUNK, dtype=torch.int64,
                                       device=batch.device))
    torch.sum(batch.view(-1) * state.weight, dim=0, dtype=torch.int64,
              out=state.folds[i // FOLD_CHUNK][i % FOLD_CHUNK])


def setup(run) -> State:
    from libacm_tpu_torch.parallel import RandomAccessCorpus

    if not hasattr(RandomAccessCorpus, "read_batch"):
        raise RuntimeError("the program has no RandomAccessCorpus.read_batch")
    p = run.params
    t0 = time.perf_counter()
    corpus = make_corpus(run.spec.config, run.seed)
    frames, chans = [], set()
    for f in corpus.files:
        h = ref.file_header(f.data)
        ch = resolve_channels(h.channels, h.wavc_file, 0)
        frames.append(h.total_values // ch)
        chans.add(ch)
    if len(chans) != 1:
        raise ValueError(f"the clips have {sorted(chans)} channels: a batch "
                         "takes one count")
    dev = run.devices[0]
    rac = RandomAccessCorpus([f.data for f in corpus.files],
                             max_cached_files=len(corpus.files), device=dev)
    t1 = time.perf_counter()
    for i in range(len(corpus.files)):
        rac.pcm_total(i)  # builds the clip's index
    t2 = time.perf_counter()
    ch = chans.pop()
    batch = batch_size(p, len(corpus.files))
    weight = fold_weight(run.seed, batch * p["segment_frames"] * ch, dev)
    state = State(corpus, rac, np.asarray(frames, np.int64), ch, weight,
                  batch)
    draw = batches(_rng(run.seed, WARM_STREAM), state.frames, batch,
                   p["segment_frames"])
    warm = State(corpus, rac, state.frames, ch, weight, batch)
    for i in range(p["warm_batches"]):
        files, starts = next(draw)
        _fold_into(warm, rac.read_batch(files, starts, p["segment_frames"]),
                   i)
    # the window keeps its first keep_batches batches: their memory is
    # taken into the allocator's cache here, so that the window's first
    # batches allocate no more than its later ones
    spare = [torch.empty((batch, p["segment_frames"], ch), dtype=torch.int16,
                         device=dev) for _ in range(p["keep_batches"])]
    del spare
    run.sync()
    print(f"crops set-up: clips {t1 - t0:.3f} s, indexes {t2 - t1:.3f} s, "
          f"warm-up {time.perf_counter() - t2:.3f} s", file=sys.stderr)
    return state


def window(run, state: State) -> None:
    p = run.params
    F = p["segment_frames"]
    draw = batches(_rng(run.seed, WINDOW_STREAM), state.frames, state.batch,
                   F)
    rac, i = state.rac, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        files, starts = next(draw)
        state.draws.append((files, starts))
        try:
            with run.tracer.span("read_batch"):
                got = rac.read_batch(files, starts, F)
            _fold_into(state, got, i)
            if i < p["keep_batches"]:
                state.kept.append(got)
        except Exception as exc:  # noqa: BLE001 (every failure counts)
            state.failed.append(i)
            state.errors.append(f"{files.tolist()} {starts.tolist()}: "
                                f"{exc!r}")
        i += 1
    run.sync()
    state.wall_s = time.perf_counter() - t0


def reference_flat(exps: list, want: int, device):
    """Every clip's exact PCM words to its decodable end, each followed by
    `want` zero words, as one int16 tensor on `device`, and each clip's
    offset in it and its decodable end."""
    ends = [min(e.total_values, e.n_good * e.block_len) for e in exps]
    zeros = torch.zeros(want, dtype=torch.int16, device=device)
    parts = []
    for e, end in zip(exps, ends):
        parts += [e.exact_pcm()[:end].to(device), zeros]
    offs = np.concatenate([[0], np.cumsum([end + want for end in ends])[:-1]])
    return torch.cat(parts), offs.astype(np.int64), np.asarray(ends)


def reference_crops(flat: torch.Tensor, offs: np.ndarray, ends: np.ndarray,
                    files: np.ndarray, starts: np.ndarray, want: int,
                    ch: int) -> torch.Tensor:
    """int16 [len(files), want]: each crop's words from the reference,
    zero past its clip's end (a start past it gives zeros)."""
    first = offs[files] + np.minimum(starts * ch, ends[files])
    idx = (torch.from_numpy(first).to(flat.device)[:, None]
           + torch.arange(want, device=flat.device))
    return flat[idx]


def fold(crops: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """int64 [n]: the fold of each batch of crops [n, batch, ...]."""
    n = crops.shape[0]
    return torch.sum(crops.reshape(n, -1) * weight, dim=1,
                     dtype=torch.int64)


def reference_folds(flat, offs, ends, draws: list, weight: torch.Tensor,
                    want: int, ch: int) -> torch.Tensor:
    """int64 [len(draws)]: the fold of each batch of the reference's
    crops, CHECK_BATCHES batches at a time."""
    out = []
    for lo in range(0, len(draws), CHECK_BATCHES):
        part = draws[lo : lo + CHECK_BATCHES]
        files = np.concatenate([f for f, _ in part])
        starts = np.concatenate([s for _, s in part])
        out.append(fold(reference_crops(flat, offs, ends, files, starts,
                                        want, ch).view(len(part), -1),
                        weight))
    return (torch.cat(out) if out else
            torch.zeros(0, dtype=torch.int64, device=flat.device))


def compare(flat, offs, ends, draws: list, kept: list, folds: torch.Tensor,
            failed: set, weight: torch.Tensor, want: int, ch: int) -> dict:
    """{name: (number wrong, limit 0)}: the kept batches crop by crop, and
    the folds of every batch whose call returned, against the
    reference's."""
    crops_wrong = 0
    for (files, starts), got in zip(draws, kept):
        exp = reference_crops(flat, offs, ends, files, starts, want, ch)
        got = got.reshape(len(files), -1).to(exp.device)
        if got.shape != exp.shape:
            crops_wrong += len(files)
            continue
        crops_wrong += int((got != exp).any(dim=1).sum())
    exp = reference_folds(flat, offs, ends, draws, weight, want, ch)
    ok = torch.ones(len(draws), dtype=torch.bool)
    ok[sorted(failed)] = False
    wrong = folds.to(exp.device) != exp
    return {"crops_wrong": (crops_wrong, 0),
            "batch_folds_wrong": (int(wrong[ok.to(exp.device)].sum()), 0)}


def work(corpus: Corpus, ends: np.ndarray, draws: list, want: int,
         ch: int) -> dict:
    """What the batches `draws` had to do, counted from the inputs: the
    payload bytes of each crop's own blocks (the bit offsets of those
    blocks in its clip, from the clip's composition), the samples
    delivered, and the fewest synthesis operations of them. `ends` is each
    clip's decodable end in words."""
    if not draws:
        return {"samples": 0, "payload_bytes": 0, "synth_ops": 0}
    cum = np.concatenate([np.cumsum(corpus.pools[f.cls].nbits[f.ids])
                          for f in corpus.files])
    bases = np.concatenate(
        [[0], np.cumsum([len(f.ids) for f in corpus.files])[:-1]])
    bl = np.asarray([corpus.classes[f.cls].block_len for f in corpus.files])
    level = np.asarray([corpus.classes[f.cls].level for f in corpus.files])
    files = np.concatenate([f for f, _ in draws])
    starts = np.concatenate([s for _, s in draws])
    w0 = np.minimum(starts * ch, ends[files])
    w1 = np.minimum(w0 + want, ends[files])
    a = w0 // bl[files]
    b = -(-w1 // bl[files])
    at = bases[files] - 1
    hi = np.where(b > 0, cum[at + np.maximum(b, 1)], 0)
    lo = np.where(a > 0, cum[at + np.maximum(a, 1)], 0)
    bits = np.where(b > a, hi - lo, 0)
    ops = sum(roofline.synth_ops(int(lv), want * int(np.sum(level[files]
                                                            == lv)))
              for lv in np.unique(level[files]))
    return {"samples": int(len(files) * want),
            "payload_bytes": int(bits.sum() // 8), "synth_ops": int(ops)}


def check(run, state: State) -> None:
    p = run.params
    want = p["segment_frames"] * state.channels
    dev = run.devices[0]
    n = len(state.draws)
    folds = (torch.cat(state.folds)[:n] if state.folds else
             torch.zeros(0, dtype=torch.int64, device=dev))
    exps = expect.expected(state.corpus, dev)
    flat, offs, ends = reference_flat(exps, want, dev)
    del exps
    run.checks = compare(flat, offs, ends, state.draws, state.kept, folds,
                         set(state.failed), state.weight, want,
                         state.channels)
    del flat
    run.checks["crops_failed"] = (len(state.failed), 0)
    done = n - len(state.failed)
    run.attempted = n * state.batch
    run.failed = len(state.failed) * state.batch
    failed = set(state.failed)
    run.record.update(batches=done, wall_s=state.wall_s,
                      errors=state.errors[:5],
                      work=work(state.corpus, ends,
                                [d for i, d in enumerate(state.draws)
                                 if i not in failed], want, state.channels))
    run.e2e["decode_Msamples_per_s"] = (
        done * state.batch * want / state.wall_s / 1e6)
