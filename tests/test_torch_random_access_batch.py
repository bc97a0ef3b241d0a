"""RandomAccessCorpus.read_batch ≡ per-crop read, zero-padded, ≡ the plain
reference, bit for bit.

On the CPU (device="cpu": the cols-wire unpack and the kernel wrapper's
plain versions), at a small size, on seeded random files and the fixtures:
every crop of a batch against `read(i, start, frames)` followed by zero
frames, and against the benchmark's plain reference (acmbench/reference,
which imports neither JAX nor the program) sliced and padded by HiFi-GAN's
rule; tolerance 0. The cases: rows == 1 (prefix fallback), level 0,
stereo, crops at block 0, crops reaching the end of a truncated file, a
stale-amp-table file (exact host decode), mixed geometries in one batch,
mixed channel counts (ValueError), a batch of one, pad=False and a stale
index on both CPU routes (the same message), the host backend, and the
spans and counters recorded only under a profiler. The cases marked
`cuda` run read_batch on a card against the CPU, and launch the fused
kernel from four threads at two shared-memory sizes.
"""

from __future__ import annotations

import pathlib
import threading

import numpy as np
import pytest
import torch

from libacm_tpu_torch import testing
from libacm_tpu_torch.parallel import RandomAccessCorpus, build_index
from libacm_tpu_torch.scan import native
from libacm_tpu_torch.utils import profiling

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native scanner did not build")

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def _reference_words(data: bytes) -> tuple[np.ndarray, int]:
    """The plain reference's exact PCM words of a stream, to its
    decodable end, and its channel count."""
    from acmbench.reference import decode as ref
    from acmbench.reference.format import resolve_channels

    h = ref.file_header(data)
    ch = resolve_channels(h.channels, h.wavc_file, 0)
    (e,) = ref.expected_files([ref.scan_file(data, h, ch)], {}, [0], "cpu")
    end = min(e.total_values, e.n_good * e.block_len)
    return e.exact_pcm()[:end].numpy(), ch


def _reference_crop(words: np.ndarray, ch: int, start: int,
                    frames: int) -> np.ndarray:
    """HiFi-GAN's crop of the reference: frames from `start`, whole
    frames only, zeros past the clip's decodable end."""
    out = np.zeros(frames * ch, dtype=np.int16)
    end = len(words) - len(words) % ch
    lo = min(max(0, start * ch), end)
    hi = min(lo + frames * ch, end)
    out[: hi - lo] = words[lo:hi]
    return out.reshape(frames, ch)


def _read_padded(rac, i: int, start: int, frames: int, ch: int):
    out = np.zeros((frames, ch), dtype=np.int16)
    got = rac.read(i, start, frames)
    out[: len(got)] = got
    return out


def _check(rac, srcs, files, starts, frames, **kw):
    got = rac.read_batch(files, starts, frames, **kw)
    assert got.dtype == torch.int16 and got.shape[:2] == (len(files), frames)
    refs = {}
    for j, (i, s) in enumerate(zip(files, starts)):
        if i not in refs:
            refs[i] = _reference_words(srcs[i])
        words, ch = refs[i]
        assert got.shape[2] == ch
        want = _reference_crop(words, ch, s, frames)
        np.testing.assert_array_equal(got[j].cpu().numpy(), want,
                                      err_msg=f"crop {j} (file {i}, {s})")
        np.testing.assert_array_equal(
            _read_padded(rac, i, s, frames, ch), want)
    return got


def _starts(rng, rac, files, frames, bl):
    """Crop starts of each kind: at block 0, inside, across a block
    boundary, reaching the clip's end, and past it."""
    out = []
    for n, i in enumerate(files):
        total = rac.pcm_total(i)
        kind = n % 5
        out.append([0, int(rng.integers(0, max(1, total))),
                    max(0, bl * int(rng.integers(1, 4)) - 3),
                    max(0, total - frames // 2), total + 7][kind])
    return out


@pytest.mark.parametrize("level,rows,nb,ch", [
    (7, 16, 9, 1), (4, 40, 7, 1), (3, 1, 10, 1), (2, 1, 6, 1),
    (0, 64, 6, 1), (7, 16, 8, 2), (5, 33, 5, 2), (1, 2, 11, 1),
])
def test_batch_of_one_geometry(level, rows, nb, ch):
    rng = np.random.default_rng(level * 31 + rows + ch)
    srcs = [testing.random_acm_bytes(rng, level=level, rows=rows,
                                     n_blocks=nb, channels=ch, max_pwr=12)
            for _ in range(5)]
    rac = RandomAccessCorpus(srcs, device="cpu", max_cached_files=8)
    bl = rows << level
    frames = max(1, (3 * bl) // (2 * ch))
    files = rng.integers(0, len(srcs), 10).tolist()
    _check(rac, srcs, files, _starts(rng, rac, files, frames, bl), frames)


def test_mixed_geometries_in_one_batch():
    rng = np.random.default_rng(5)
    shapes = [(7, 16, 8), (4, 40, 6), (3, 1, 9), (0, 64, 5), (7, 16, 3)]
    srcs = [testing.random_acm_bytes(rng, level=lv, rows=r, n_blocks=nb,
                                     max_pwr=12) for lv, r, nb in shapes]
    srcs.append(srcs[0][: len(srcs[0]) * 2 // 3])  # truncated
    rac = RandomAccessCorpus(srcs, device="cpu")
    frames = 3000
    files = [0, 1, 2, 3, 4, 5, 1, 0, 5, 3]
    _check(rac, srcs, files, _starts(rng, rac, files, frames, 2048), frames)


@pytest.mark.parametrize("name", [
    "music_44k_stereo", "oddtotal_stereo", "wavc_22k", "rows1", "level0",
    "trunc_midfiller", "partial_total", "speech_22k_mono", "rows4095",
])
def test_fixture_crops(name):
    data = (FIXTURES / f"{name}.acm").read_bytes()
    rac = RandomAccessCorpus([data], device="cpu")
    total = rac.pcm_total(0)
    bl = build_index(data).header.block_len
    for frames in (1, 700, bl + 5):
        starts = [0, 1, bl - 2, bl, total // 2, max(0, total - 3),
                  total - frames // 3, total + 1]
        _check(rac, [data], [0] * len(starts), [max(0, s) for s in starts],
               frames)


def test_truncated_file_crop_to_its_end():
    rng = np.random.default_rng(9)
    data = testing.random_acm_bytes(rng, level=3, rows=20, n_blocks=6)
    cut = data[: len(data) * 2 // 3]
    idx = build_index(cut)
    assert idx.n_good < 6
    avail = idx.words_avail
    rac = RandomAccessCorpus([cut, data], device="cpu")
    got = _check(rac, [cut, data], [0, 1, 0], [avail - 50, avail - 50,
                                               avail - 300], 200)
    assert not got[0, 50:].any() and got[1, 50:].any()


def test_stale_amp_table_file_in_a_batch():
    stale = (FIXTURES / "stale_table_fuzz_2103.acm").read_bytes()
    assert build_index(stale).oor
    rng = np.random.default_rng(3)
    clean = testing.random_acm_bytes(rng, level=3, rows=58, n_blocks=4)
    srcs = [stale, clean]
    rac = RandomAccessCorpus(srcs, device="cpu")
    _check(rac, srcs, [0, 1, 0, 1, 0], [0, 100, 700, 5, 900], 300)
    _check(rac, srcs, [0], [3], 50)  # a batch of the stale file alone


def test_batch_of_one():
    rng = np.random.default_rng(11)
    srcs = [testing.random_acm_bytes(rng, level=7, rows=16, n_blocks=6)]
    rac = RandomAccessCorpus(srcs, device="cpu")
    for start in (0, 2047, 2048, 5000, 12288 - 100, 20000):
        _check(rac, srcs, [0], [start], 1024)


def test_same_clip_twice_and_order_kept():
    rng = np.random.default_rng(12)
    srcs = [testing.random_acm_bytes(rng, level=4, rows=16, n_blocks=8)
            for _ in range(3)]
    rac = RandomAccessCorpus(srcs, device="cpu")
    _check(rac, srcs, [2, 0, 2, 1, 0], [10, 300, 10, 900, 0], 256)


def test_mixed_channel_counts_raise():
    rng = np.random.default_rng(13)
    srcs = [testing.random_acm_bytes(rng, level=4, rows=16, n_blocks=4,
                                     channels=c) for c in (1, 2)]
    rac = RandomAccessCorpus(srcs, device="cpu")
    with pytest.raises(ValueError, match="channel count"):
        rac.read_batch([0, 1], [0, 0], 64)


def test_bad_arguments_raise():
    rng = np.random.default_rng(14)
    srcs = [testing.random_acm_bytes(rng, level=4, rows=16, n_blocks=4)]
    rac = RandomAccessCorpus(srcs, device="cpu")
    with pytest.raises(ValueError, match="starts"):
        rac.read_batch([0, 0], [0], 64)
    with pytest.raises(ValueError, match="at least one"):
        rac.read_batch([], [], 64)
    with pytest.raises(ValueError, match="frames"):
        rac.read_batch([0], [0], -1)
    assert rac.read_batch([0], [5], 0).shape == (1, 0, 1)


#: RandomAccessCorpus keyword arguments of the two CPU routes
ROUTES = {"device": {"device": "cpu"}, "host": {"backend": "host"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pad_false_raises_past_the_end_only(route):
    rng = np.random.default_rng(15)
    srcs = [testing.random_acm_bytes(rng, level=4, rows=16, n_blocks=4)]
    rac = RandomAccessCorpus(srcs, **ROUTES[route])
    total = rac.pcm_total(0)
    _check(rac, srcs, [0, 0], [0, total - 100], 100, pad=False)
    with pytest.raises(ValueError) as exc:
        rac.read_batch([0, 0], [0, total - 99], 100, pad=False)
    assert str(exc.value) == ("crop 1 (file 0, frame %d): 99 of 100 frames "
                              "decodable and pad=False" % (total - 99))


def test_host_backend_equals_device_route():
    rng = np.random.default_rng(16)
    srcs = [testing.random_acm_bytes(rng, level=lv, rows=r, n_blocks=6)
            for lv, r in ((7, 16), (3, 1), (0, 64))]
    files, starts = [0, 1, 2, 0, 1], [0, 50, 100, 9000, 5]
    dev = RandomAccessCorpus(srcs, device="cpu").read_batch(files, starts,
                                                            900)
    host = RandomAccessCorpus(srcs, backend="host").read_batch(files, starts,
                                                               900)
    assert torch.equal(dev, host)


def test_small_file_cache_rereads_sources(tmp_path):
    rng = np.random.default_rng(17)
    srcs = [testing.random_acm_bytes(rng, level=5, rows=8, n_blocks=5)
            for _ in range(6)]
    paths = []
    for i, d in enumerate(srcs):
        p = tmp_path / f"{i}.acm"
        p.write_bytes(d)
        paths.append(str(p))
    rac = RandomAccessCorpus(paths, device="cpu", max_cached_files=2)
    files = [0, 3, 5, 1, 4, 2, 0]
    _check(rac, srcs, files, [7 * i for i in range(len(files))], 300)
    assert rac.cached_files == 2


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stale_index_raises(route):
    rng = np.random.default_rng(31)
    data = testing.speech_acm_bytes(rng, level=4, rows=8, n_blocks=10)
    rac = RandomAccessCorpus([data], **ROUTES[route])
    rac.pcm_total(0)  # the index of the whole file
    idx = build_index(data)
    rac._data_lru[0] = data[: len(data) // 2]  # the bytes changed since
    with pytest.raises(ValueError) as exc:
        rac.read_batch([0], [6 * idx.header.block_len], 500)
    # blocks [5, 10) from block 6's warm-up block, which starts past the
    # bytes left
    assert str(exc.value) == (
        "index/stream mismatch: indexed span of 5 blocks decodes only 0 — "
        "stale BlockIndex for these bytes (rebuild with build_index)")


BATCH_SPANS = {"libacm.random_access.batch", "libacm.random_access.index",
               "libacm.random_access.scan", "libacm.random_access.copy",
               "libacm.random_access.launch"}


def _traced_batch(rac, files, starts, frames):
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = rac.read_batch(files, starts, frames)
    return got, profiling.totals(), profiling.records()


def test_spans_and_counters_under_a_profiler_only():
    rng = np.random.default_rng(18)
    srcs = [testing.random_acm_bytes(rng, level=7, rows=16, n_blocks=n)
            for n in (5, 9, 3)]
    srcs.append(testing.random_acm_bytes(rng, level=3, rows=1, n_blocks=6))
    rac = RandomAccessCorpus(srcs, device="cpu")
    files, starts, frames = [0, 1, 2, 1, 3], [0, 3000, 4000, 9000, 20], 2500
    profiling.reset()
    plain = rac.read_batch(files, starts, frames)
    assert profiling.totals() == {"spans": {}, "counters": {}}
    got, t, recs = _traced_batch(rac, files, starts, frames)
    assert torch.equal(got, plain)
    assert set(t["spans"]) == BATCH_SPANS
    assert t["spans"]["libacm.random_access.batch"]["count"] == 1
    # one native call plans, scans and lays out the batch's two geometries
    assert t["spans"]["libacm.random_access.scan"]["count"] == 1
    (root,) = [r for r in recs if r.name == "libacm.random_access.batch"]
    assert all(r.call == root.id for r in recs)
    assert all(r.parent == root.id for r in recs if r is not root)
    c = t["counters"]
    assert c["libacm.random_access.crops"] == 5
    # 7/16 (2048 words a block), crops of 2500: file 0 from 0 is blocks
    # [0, 2), no warm-up; file 1 from 3000 is [0, 3), 1 warm-up; file 2
    # from 4000 is [0, 3) of its 3, 1 warm-up, and its row holds 4 blocks
    # for the gather; file 1 from 9000 is [3, 6), 1 warm-up: [4, 8] -> 8
    # a row, 32 in all, 11 synthesized for the spans, 3 of them warm-up.
    # rows == 1 at 3/1 (8 words a block), file 3 from 20: the prefix
    # [0, 6), 2 warm-up, and 315 blocks for the gather -> 320.
    assert c["libacm.random_access.blocks"] == 32 + 320
    assert c["libacm.random_access.warmup_blocks"] == 3 + 2
    assert c["libacm.random_access.pad_blocks"] == (32 - 11) + (320 - 6)
    assert "libacm.copy.h2d_bytes.pinned" not in c  # no card: no copy


def test_host_decode_span_for_a_stale_file():
    stale = (FIXTURES / "stale_table_fuzz_2103.acm").read_bytes()
    rac = RandomAccessCorpus([stale], device="cpu")
    _, t, _ = _traced_batch(rac, [0, 0], [0, 400], 100)
    assert t["spans"]["libacm.random_access.host_decode"]["count"] == 2
    assert "libacm.random_access.scan" not in t["spans"]
    assert "libacm.random_access.blocks" not in t["counters"]


# -- on a card ---------------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_batch_equals_cpu_and_copies_from_pinned_memory():
    dev = _card()
    rng = np.random.default_rng(19)
    shapes = [(7, 16, 40), (7, 16, 12), (4, 40, 9), (3, 1, 30), (0, 64, 7)]
    srcs = [testing.random_acm_bytes(rng, level=lv, rows=r, n_blocks=nb,
                                     max_pwr=12) for lv, r, nb in shapes]
    srcs.append(srcs[0][: len(srcs[0]) // 2])
    srcs.append((FIXTURES / "stale_table_fuzz_2103.acm").read_bytes())
    card = RandomAccessCorpus(srcs, device=dev)
    cpu = RandomAccessCorpus(srcs, device="cpu")
    for _ in range(20):
        files = rng.integers(0, len(srcs), 16).tolist()
        starts = [int(rng.integers(0, cpu.pcm_total(i) + 100))
                  for i in files]
        got = card.read_batch(files, starts, 8192)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), cpu.read_batch(files, starts, 8192))
    _, t, _ = _traced_batch(card, [0, 1], [100, 200], 8192)
    assert t["counters"]["libacm.copy.h2d_bytes.pinned"] > 0


@pytest.mark.cuda
def test_card_batch_of_the_native_call_copies_its_blob_once():
    """Batches of 16 crops of 8,192 frames over 7/16 speech clips, each
    planned, scanned and laid out by the one native call, are bit-equal to
    the CPU route; every crop takes the call, and the pinned copy counts
    the call's blob once a batch."""
    from libacm_tpu_torch.parallel import random_access

    dev = _card()
    rng = np.random.default_rng(21)
    srcs = [testing.speech_acm_bytes(rng, level=7, rows=16, n_blocks=int(n))
            for n in rng.integers(12, 40, 24)]
    card = RandomAccessCorpus(srcs, device=dev, max_cached_files=24)
    cpu = RandomAccessCorpus(srcs, device="cpu", max_cached_files=24)
    for _ in range(4):
        files = rng.permutation(24)[:16].tolist()
        starts = [int(rng.integers(0, max(0, cpu.pcm_total(i) - 8192) + 1))
                  for i in files]
        got, t, _ = _traced_batch(card, files, starts, 8192)
        blob_bytes = int(random_access._TLS.crop_tables[0][1])
        assert torch.equal(got.cpu(), cpu.read_batch(files, starts, 8192))
        c = t["counters"]
        assert c["libacm.random_access.native_crops"] == 16
        assert c["libacm.random_access.crops"] == 16
        assert c["libacm.copy.h2d_bytes.pinned"] == blob_bytes
        assert t["spans"]["libacm.random_access.copy"]["count"] == 1


@pytest.mark.cuda
def test_fused_launches_from_four_threads_at_two_sizes():
    """Four threads launch the fused kernel about 2,000 times each,
    alternating two shapes of different shared memory: every result is
    bit-equal to the one-thread result, and no launch fails."""
    from libacm_tpu_torch.ops import synth_cuda as sc

    dev = _card()
    # a batch of crops (33,808 B a CTA) and a 10/4 file (73,744 B, above
    # the 48 KB a launch may take without the attribute)
    shapes = [(7, 16, 16, 8), (10, 4, 2, 9)]
    smem = [sc.fused_config(lv, r, B, nb, dev)["smem_bytes"]
            for lv, r, B, nb in shapes]
    assert smem[0] < 48 * 1024 < smem[1]
    rng = np.random.default_rng(20)
    inputs, want = [], []
    for lv, r, B, nb in shapes:
        cols = 1 << lv
        k = torch.from_numpy(rng.integers(-2000, 2000, (B, nb, r, cols))
                             .astype(np.int16)).to(dev)
        v = torch.from_numpy(rng.integers(0, 1 << 16, (B, nb))
                             .astype(np.int32)).to(dev)
        w = torch.zeros((B, 2 * cols - 2), dtype=torch.int32, device=dev)
        inputs.append((k, v, w, lv, r))
        want.append(sc.synth_pcm_batch(k, v, w, level=lv, rows=r)[0].cpu())
    errors, wrong = [], []

    def work(t: int) -> None:
        stream = torch.cuda.Stream(dev)
        try:
            with torch.cuda.stream(stream):
                outs = []
                for n in range(2000):
                    j = (n + t) % 2
                    k, v, w, lv, r = inputs[j]
                    outs.append((j, sc.synth_pcm_batch(k, v, w, level=lv,
                                                       rows=r)[0]))
                    if len(outs) == 100:
                        stream.synchronize()
                        wrong.extend(n for n, (j, o) in enumerate(outs)
                                     if not torch.equal(o.cpu(), want[j]))
                        outs.clear()
                stream.synchronize()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors[:3]
    assert not wrong
