"""The CUDA synthesis kernel ≡ its plain version, on the card.

Marked `cuda`: each test decides inside itself whether a card is present
and skips when there is none (the CPU runs cover the plain version and a
model of the kernel's tiling in test_torch_synth.py). On a machine with
an H100 run `python -m pytest --noconftest tests/test_torch_cuda.py`.
Further tests drive the reference API (stream, read_segment,
decode_scan_result) through the kernel against the native host synth;
the last ones the carry handed from launch to launch on the card, the
windowed decode_stream_device and a corpus sharded over one card named
twice.
"""

import pathlib

import numpy as np
import pytest
import torch

from libacm_tpu_torch.ops import synth_cuda as sc
from libacm_tpu_torch.ops import synth_torch as st

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _inputs(dev, level, rows, B, nb, k_offset=0):
    """Random k, vals, wrap0 on the card; k starts k_offset int16 past an
    allocation's start (so 2 * k_offset bytes off its alignment)."""
    rng = np.random.default_rng(level * 131 + rows)
    cols = 1 << level
    kh = torch.from_numpy(rng.integers(-2000, 2000, (B, nb, rows, cols))
                          .astype(np.int16))
    k = torch.empty(k_offset + kh.numel(), dtype=torch.int16, device=dev)
    k = k[k_offset:].view(B, nb, rows, cols)
    k.copy_(kh)
    v = torch.from_numpy(rng.integers(0, 1 << 16, (B, nb))
                         .astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.integers(-500, 500, (B, max(2 * cols - 2, 1)))
                         .astype(np.int32)).to(dev)
    return k, v, w


@pytest.mark.parametrize("level,rows,B,nb,route", [
    (7, 16, 3, 41, "synth_fused"), (4, 40, 2, 37, "synth_fused"),
    (10, 4, 2, 9, "synth_fused"), (5, 33, 2, 5, "synth_fused"),
    (9, 3, 2, 6, "synth_fused"), (1, 2, 2, 11, "synth_fused"),
    (0, 2048, 2, 5, "synth_level0"), (10, 1, 2, 6, "synth_fused"),
    (14, 1, 1, 4, "synth_tail"), (15, 16, 1, 3, "synth_tail"),
    (2, 1, 3, 7, "synth_fused"),
    # rows == 1 on the fused route (two warm-up blocks from level 2): levels
    # 1, 7, 12, and spans of one block, so that spans start at block 1
    (1, 1, 2, 9, "synth_fused"), (7, 1, 2, 40, "synth_fused"),
    (12, 1, 1, 5, "synth_fused"), (7, 1, 1, 100, "synth_fused"),
    # one CTA per SM: a block does not leave room for two
    (13, 2, 1, 4, "synth_fused"), (12, 4, 2, 3, "synth_fused"),
    (10, 16, 2, 8, "synth_fused"), (12, 3, 1, 7, "synth_fused"),
    (11, 8, 1, 3, "synth_fused"), (13, 1, 2, 5, "synth_fused"),
    # level 0 at other widths; blocks over 227 KB: the tail alone (reading
    # k), one and two wide passes before it, several files
    (0, 256, 3, 20, "synth_level0"), (0, 50, 2, 9, "synth_level0"),
    (0, 3, 2, 11, "synth_level0"), (11, 16, 2, 2, "synth_tail"),
    (12, 9, 2, 2, "synth_tail"), (13, 3, 3, 2, "synth_tail"),
    (14, 2, 2, 3, "synth_tail"),
    # fused edges: many files; nb below one tile; n % 8 != 0 (copies of
    # k narrower than 16 bytes); spans of several tiles cut mid-file; a
    # tile of one block
    (7, 16, 40, 13, "synth_fused"), (7, 16, 1, 3, "synth_fused"),
    (1, 3, 2, 9, "synth_fused"), (2, 3, 3, 7, "synth_fused"),
    (7, 16, 100, 20, "synth_fused"), (4, 40, 200, 40, "synth_fused"),
    (12, 2, 1, 5, "synth_fused"),
])
def test_kernel_matches_plain(level, rows, B, nb, route):
    dev = _card()
    k, v, w = _inputs(dev, level, rows, B, nb)
    sc.reset_launches()
    got_pcm, got_w = sc.synth_pcm_batch(k, v, w, level=level, rows=rows)
    torch.cuda.synchronize()
    assert sc.launches[route] >= 1
    assert {n: c for n, c in sc.launches.items() if c} == sc.kernel_launches(
        level, rows, nb)
    want_pcm, want_w = st.synth_pcm_batch(k, v, w, level=level, rows=rows)
    assert torch.equal(got_pcm, want_pcm)
    if level:
        assert torch.equal(got_w, want_w)


def test_rows1_stream_window_is_one_fused_launch():
    """A rows == 1 stream decoded in windows: one fused launch a window,
    PCM equal to the host decoder."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import (decode_corpus_host,
                                           decode_stream_device)

    _card()
    data = testing.speech_acm_bytes(np.random.default_rng(8), level=7,
                                    rows=1, n_blocks=300)
    host = decode_corpus_host([data])[0]
    sc.reset_launches()
    pcm, meta = decode_stream_device(data, device="cuda", window_blocks=64)
    torch.cuda.synchronize()
    assert sc.launches["synth_fused"] == 5
    assert sum(sc.launches.values()) == 5
    got = pcm.cpu().numpy().reshape(-1)[: len(host.pcm)]
    np.testing.assert_array_equal(got, host.pcm)
    assert (meta.status, meta.filler_words) == (host.status,
                                                host.filler_words)


def test_kernel_rejects_bad_input():
    dev = _card()
    k = torch.zeros((1, 2, 4, 8), dtype=torch.int32, device=dev)
    v = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    w = torch.zeros((1, 14), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sc.synth_pcm_batch(k, v, w, level=3, rows=4)


@pytest.mark.parametrize("k_offset", [1, 2, 4])
def test_fused_kernel_unaligned_k(k_offset):
    """k 2, 4 or 8 bytes past 16-byte alignment: the kernel stages it with
    narrower copies and stays bit-equal."""
    dev = _card()
    k, v, w = _inputs(dev, 7, 16, 3, 9, k_offset=k_offset)
    assert k.data_ptr() % 16 == 2 * k_offset
    sc.reset_launches()
    got_pcm, got_w = sc.synth_pcm_batch(k, v, w, level=7, rows=16)
    torch.cuda.synchronize()
    assert sc.launches["synth_fused"] == 1
    want_pcm, want_w = st.synth_pcm_batch(k, v, w, level=7, rows=16)
    assert torch.equal(got_pcm, want_pcm)
    assert torch.equal(got_w, want_w)


@pytest.mark.parametrize("level,rows,nb", [(0, 2048, 7), (0, 250, 5),
                                           (14, 1, 3), (11, 16, 2)])
@pytest.mark.parametrize("k_offset", [1, 2, 4])
def test_level0_and_large_blocks_unaligned_k(level, rows, nb, k_offset):
    """k 2, 4 or 8 bytes past 16-byte alignment: level 0 takes narrower
    vectors, the first wide pass scalar loads of k; bit-equal."""
    dev = _card()
    k, v, w = _inputs(dev, level, rows, 2, nb, k_offset=k_offset)
    sc.reset_launches()
    got_pcm, got_w = sc.synth_pcm_batch(k, v, w, level=level, rows=rows)
    torch.cuda.synchronize()
    assert {n: c for n, c in sc.launches.items() if c} == sc.kernel_launches(
        level, rows, nb)
    want_pcm, want_w = st.synth_pcm_batch(k, v, w, level=level, rows=rows)
    assert torch.equal(got_pcm, want_pcm)
    if level:
        assert torch.equal(got_w, want_w)


def test_fused_config_two_ctas_per_sm():
    """The main path's fused shapes get at least two resident CTAs per SM
    and a grid of at most one wave."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for level, rows, B, nb in [(7, 16, 25, 320), (4, 40, 15, 1216),
                               (10, 4, 10, 160)]:
        cfg = sc.fused_config(level, rows, B, nb, dev)
        assert cfg["ctas_per_sm"] >= 2, (level, rows, cfg)
        assert cfg["grid"][0] * cfg["grid"][1] <= sms * cfg["ctas_per_sm"]


def test_fused_config_one_cta_per_sm():
    """Blocks that leave no room for a second CTA take the fused route at
    one resident CTA per SM, within the opt-in limit of 227 KB."""
    dev = _card()
    for level, rows, B, nb in [(13, 2, 1, 4), (12, 4, 2, 3), (10, 16, 2, 8),
                               (12, 3, 1, 7), (11, 8, 1, 3), (13, 1, 2, 5)]:
        cfg = sc.fused_config(level, rows, B, nb, dev)
        assert cfg["ctas_per_sm"] == 1, (level, rows, cfg)
        assert cfg["smem_bytes"] <= sc.ONE_CTA_SMEM


@pytest.mark.parametrize("seed", range(8))
def test_kernel_matches_plain_random_geometries(seed):
    """Six random geometries per seed (level 1-12, rows 1-48, up to 40
    files of up to 64 blocks, at most 4 M samples), whichever route each
    takes: PCM and final carry bit-equal to the plain version."""
    dev = _card()
    rng = np.random.default_rng(1000 + seed)
    for _ in range(6):
        level = int(rng.integers(1, 13))
        rows = int(rng.integers(1, 49))
        n = rows << level
        B = int(rng.integers(1, 41))
        nb = int(rng.integers(1, 65))
        while B * nb * n > 1 << 22 and nb > 1:
            nb //= 2
        B = max(1, min(B, (1 << 22) // (nb * n)))
        cols = 1 << level
        k = torch.from_numpy(rng.integers(-2000, 2000, (B, nb, rows, cols))
                             .astype(np.int16)).to(dev)
        v = torch.from_numpy(rng.integers(0, 1 << 16, (B, nb))
                             .astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(-500, 500, (B, 2 * cols - 2))
                             .astype(np.int32)).to(dev)
        got_pcm, got_w = sc.synth_pcm_batch(k, v, w, level=level, rows=rows)
        torch.cuda.synchronize()
        want_pcm, want_w = st.synth_pcm_batch(k, v, w, level=level,
                                              rows=rows)
        geom = (level, rows, B, nb)
        assert torch.equal(got_pcm, want_pcm), geom
        assert torch.equal(got_w, want_w), geom


# -- the reference API on the card ---------------------------------------------

_FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def _drain(s):
    from libacm_tpu_torch import AcmException

    out = bytearray()
    while True:
        try:
            b = s.read_loop(1 << 16)
        except AcmException:
            continue  # keep reading past error events
        if not b:
            return bytes(out)
        out += b


@pytest.mark.parametrize("name", sorted(
    p.stem for p in _FIXTURES.glob("*.acm")))
def test_stream_on_card_matches_host(name):
    """Each fixture decodes through the kernel (one file per launch)
    byte-equal to the native host synth, then again after a seek back."""
    from libacm_tpu_torch import AcmStream, acm_open_file
    from libacm_tpu_torch import io as tio

    _card()
    path = _FIXTURES / f"{name}.acm"
    got = acm_open_file(path, device="cuda")
    want = AcmStream(tio.FileSource(path), synth_backend="host")
    assert _drain(got) == _drain(want)
    assert got.seek_pcm(0) == want.seek_pcm(0)
    assert _drain(got) == _drain(want)


@pytest.mark.parametrize("level,rows,nb", [
    (7, 16, 40), (4, 40, 30), (10, 4, 12), (3, 1, 50), (0, 256, 20),
    (2, 2, 60)])
def test_read_segment_on_card_matches_host(level, rows, nb):
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import build_index, read_segment

    _card()
    rng = np.random.default_rng(level * 7 + rows)
    data = testing.speech_acm_bytes(rng, level=level, rows=rows,
                                    n_blocks=nb)
    idx = build_index(data)
    total = min(idx.header.total_values, idx.words_avail)
    sc.reset_launches()
    for _ in range(40):
        start = int(rng.integers(0, total))
        n = int(rng.integers(1, 4 * idx.header.block_len))
        got = read_segment(data, idx, start, n, device="cuda")
        want = read_segment(data, idx, start, n, backend="host")
        np.testing.assert_array_equal(got, want, err_msg=f"({start}, {n})")
    assert sum(sc.launches.values()) >= 40


def test_decode_scan_result_level0_zero_width_carry():
    """Level 0: the carry has no words; the level-0 kernel takes a
    [1, 0] wrap0 in one launch and the words equal the host synth."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.scan import native

    _card()
    data = testing.speech_acm_bytes(np.random.default_rng(3), level=0,
                                    rows=2048, n_blocks=7)
    scan = native.scan_bytes(data)
    assert scan.header.wrapbuf_len == 0
    sc.reset_launches()
    got = st.decode_scan_result(scan, device="cuda")
    assert sc.launches["synth_level0"] == 1
    assert sum(sc.launches.values()) == 1
    np.testing.assert_array_equal(got, st.decode_scan_result(scan,
                                                             backend="host"))


# -- carry on the card, windows, device lists -----------------------------------


@pytest.mark.parametrize("level,rows,nb,m", [
    (7, 16, 40, 17), (4, 40, 30, 1), (10, 4, 12, 11), (3, 2, 9, 4),
    (5, 1, 20, 7), (0, 256, 6, 2)])
def test_split_launch_hands_the_carry_over_on_the_card(level, rows, nb, m):
    """Blocks [0, nb) in one launch ≡ [0, m) then [m, nb) with wrapf as
    the second launch's wrap0, never fetched; both ≡ the plain version.
    B = 1 with a non-zero carry-in is what a stream window is."""
    dev = _card()
    k, v, w = _inputs(dev, level, rows, 1, nb)
    whole = sc.synth_pcm_batch(k, v, w, level=level, rows=rows)
    a = sc.synth_pcm_batch(k[:, :m].contiguous(), v[:, :m].contiguous(), w,
                           level=level, rows=rows)
    assert a[1].device == dev
    b = sc.synth_pcm_batch(k[:, m:].contiguous(), v[:, m:].contiguous(),
                           a[1], level=level, rows=rows)
    torch.cuda.synchronize()
    want = st.synth_pcm_batch(k, v, w, level=level, rows=rows)
    assert torch.equal(whole[0], want[0])
    assert torch.equal(torch.cat([a[0], b[0]], dim=1), want[0])
    if level:
        assert torch.equal(whole[1], want[1])
        assert torch.equal(b[1], want[1])


@pytest.mark.parametrize("level,rows,nb", [(6, 16, 40), (5, 1, 30),
                                           (0, 64, 12)])
@pytest.mark.parametrize("window", [None, 8, 7])
def test_stream_device_on_card_matches_host(level, rows, nb, window):
    """decode_stream_device on the card, one device and one card named
    twice: PCM, status and filler equal to the host decoder."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import (decode_corpus_host,
                                           decode_stream_device)

    _card()
    data = testing.speech_acm_bytes(np.random.default_rng(33), level=level,
                                    rows=rows, n_blocks=nb)
    host = decode_corpus_host([data])[0]
    for kw in ({"device": "cuda"}, {"devices": ["cuda:0", "cuda:0"]}):
        sc.reset_launches()
        pcm, meta = decode_stream_device(data, window_blocks=window, **kw)
        spans = pcm if isinstance(pcm, list) else [pcm]
        assert all(p.device.type == "cuda" for p in spans)
        got = torch.cat(spans).cpu().numpy().reshape(-1)
        np.testing.assert_array_equal(got[: len(host.pcm)], host.pcm)
        assert (meta.status, meta.filler_words) == (host.status,
                                                    host.filler_words)
        assert sum(sc.launches.values()) >= 1


def test_corpus_sharded_over_one_card_twice_matches_one_device():
    """devices=[cuda:0, cuda:0]: the groups share a pool key, so this
    holds the buffer pins, the grouping and the result order."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import (decode_corpus_device,
                                           decode_corpus_host)

    _card()
    rng = np.random.default_rng(21)
    files = [testing.speech_acm_bytes(rng, level=int(rng.choice([3, 6])),
                                      rows=16, n_blocks=4,
                                      channels=int(rng.integers(1, 3)))
             for _ in range(23)]
    files[5] = files[5][: len(files[5]) - 10]
    files[9] = b"not an ACM stream"
    host = decode_corpus_host(files)
    one = decode_corpus_device(files, device="cuda", chunk_files=2)
    for _ in range(3):  # reuse of pooled buffers across calls
        two = decode_corpus_device(files, devices=["cuda:0", "cuda:0"],
                                   chunk_files=2)
        assert two.block_until_ready().checksum() == one.checksum()
        for h, g in zip(host, two.to_results()):
            assert (h.status, h.filler_words) == (g.status, g.filler_words)
            if h.pcm is None:
                assert g.pcm is None
            else:
                np.testing.assert_array_equal(h.pcm, g.pcm)


# -- the cols-wire unpack kernel (csrc/unpack.cu) -----------------------------


def _bench():
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import bench_torch

    return bench_torch


def _unpack_equal(blob, kw):
    """The kernel on a card blob ≡ the plain version on the same blob (on
    the card and on the CPU), with the launches of one call."""
    from libacm_tpu_torch.ops import unpack_cuda as uc

    uc.reset_launches()
    got = st.unpack_cols_blob(blob, **kw)
    torch.cuda.synchronize()
    assert dict(uc.launches) == {
        k: uc.unpack_launches(kw["level"], kw["batch"], kw["nb"],
                              kw["has_wrap"]).get(k, 0) for k in uc.launches}
    for want in (st.unpack_cols_blob_plain(blob, **kw),
                 st.unpack_cols_blob_plain(blob.cpu(), **kw)):
        for g, w, name in zip(got, want, ("k", "vals", "wrap0")):
            assert (g is None) == (w is None), name
            if g is not None:
                assert g.dtype == w.dtype and g.shape == w.shape, name
                assert g.is_contiguous() and g.device == blob.device, name
                assert torch.equal(g.cpu(), w.cpu()), name


@pytest.mark.parametrize("name", [
    "family absent (payload < 2 bytes)", "empty width stream",
    "width stream shorter than the ordinals (clamp)",
    "payload shorter than the columns (clamped words)",
    "16-bit values in the last word", "sections at odd byte offsets",
    "padding codes at level 0", "padding codes at level 1", "rows == 1",
    "level 0, rows 2048", "N not a multiple of a tile",
    "a tile with no non-zero column", "has_wrap false",
    "several tiles of several width tiles",
    "a span that ends at the stream's last word",
    "ordinals past 2L at a width-tile boundary",
    "a 1-byte payload among many tiles", "a width stream of 40 tiles",
    "a width stream of 293 tiles"])
def test_unpack_kernel_matches_plain_on_edges(name):
    dev = _card()
    wire = _bench().edge_wire(name)
    _unpack_equal(torch.from_numpy(wire["blob"]).to(dev),
                  _bench().wire_args(wire))


@pytest.mark.parametrize("seed", range(12))
def test_unpack_kernel_matches_plain_on_random_wires(seed):
    """Random geometries and section lengths from a numpy seed: natural,
    short, empty or single-byte payloads and width streams."""
    dev = _card()
    wire = _bench().random_wire(1000 + seed)
    _unpack_equal(torch.from_numpy(wire["blob"]).to(dev),
                  _bench().wire_args(wire))


@pytest.mark.parametrize("seed", range(24))
def test_unpack_kernel_matches_plain_on_the_smoke_random_wires(seed):
    """chip_smoke.py's UNPACK_RANDOM wires (bench_torch.random_wire)."""
    dev = _card()
    wire = _bench().random_wire(seed)
    _unpack_equal(torch.from_numpy(wire["blob"]).to(dev),
                  _bench().wire_args(wire))


@pytest.mark.parametrize("tiles", ["default", "full"])
def test_unpack_kernel_race_wire(tiles, monkeypatch):
    """A wire of 2,000 column tiles (10/4, [10, 400]) held to the plain
    version, then decoded 50 times in a row, each equal to the first: a
    look-back race would show as a difference. "full": tiles of
    TILE_VALUES values at level 0, rows 2048 (130 tiles of 16 blocks)."""
    from libacm_tpu_torch.ops import unpack_cuda as uc

    dev = _card()
    if tiles == "full":
        monkeypatch.setattr(uc, "TARGET_TILES", 0)
        wire = _bench().synthetic_wire(98, 0, 2048, 5, 416)
    else:
        wire = _bench().synthetic_wire(99, 10, 4, 10, 400)
    blob, kw = torch.from_numpy(wire["blob"]).to(dev), _bench().wire_args(wire)
    assert uc.plan(**kw)["nct"] == (2000 if tiles == "default" else 130)
    _unpack_equal(blob, kw)
    first = uc.unpack_cols_blob(blob, **kw)
    for _ in range(50):
        got = uc.unpack_cols_blob(blob, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got[:2], first[:2]))


@pytest.mark.parametrize("level,rows,nb", [
    (7, 16, 40), (4, 40, 30), (10, 4, 12), (0, 2048, 5), (2, 1, 60),
    (1, 4095, 2), (12, 2, 3)])
def test_unpack_kernel_on_the_corpus_wires(level, rows, nb):
    """The scanner's chunk wires, as the corpus path makes them: each
    held to the plain version; the decode equal to the host decoder, with
    one unpack launch a chunk."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import unpack_cuda as uc
    from libacm_tpu_torch.parallel import (decode_corpus_device,
                                           decode_corpus_host)

    _card()
    rng = np.random.default_rng(level * 11 + rows)
    files = [testing.speech_acm_bytes(rng, level=level, rows=rows,
                                      n_blocks=nb) for _ in range(3)]
    files.append(testing.random_acm_bytes(rng, level=level, rows=rows,
                                          n_blocks=nb, max_pwr=12))
    files.append(files[0][: len(files[0]) * 2 // 3])
    uc.reset_launches()
    with _bench().capture_wires() as wires:
        dc = decode_corpus_device(files, device="cuda", chunk_files=2)
        dc.block_until_ready()
    assert len(wires) >= 3  # chunks of at most two files
    assert dict(uc.launches) == {k: len(wires) for k in uc.launches}
    for h, g in zip(decode_corpus_host(files), dc.to_results()):
        assert (h.status, h.filler_words) == (g.status, g.filler_words)
        if h.pcm is None:
            assert g.pcm is None
        else:
            np.testing.assert_array_equal(h.pcm, g.pcm)
    for wire in wires:
        assert wire["blob"].device.type == "cuda"
        _unpack_equal(wire["blob"], _bench().wire_args(wire))


def _device_ops(fn) -> int:
    """The device operations of fn() under bench_torch.profiled, which
    queues spin kernels first and counts only a window that recorded one
    (so none of fn's was lost); at least 1, or the count is unknown and
    would prove nothing."""
    from libacm_tpu_torch.ops import kernels

    def window():
        kernels.reset_all()  # the launches of the window that is kept
        fn()

    _, ranked = _bench().profiled(torch, window)
    ops = sum(count for _, count, _ in ranked)
    assert ops >= 1, "the profiler recorded no device operation"
    return ops


def test_unpack_kernel_launches_per_window_and_segment():
    """A stream window: one copy, one unpack launch and one synthesis
    launch (and one fill and one cat a decode); a random-access segment:
    a copy in, the unpack, the synthesis and a copy out, under the
    profiler."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import unpack_cuda as uc
    from libacm_tpu_torch.parallel import (build_index, decode_stream_device,
                                           read_segment)

    _card()
    data = testing.speech_acm_bytes(np.random.default_rng(4), level=7,
                                    rows=16, n_blocks=100)
    decode_stream_device(data, device="cuda", window_blocks=25)  # warm
    idx = build_index(data)
    read_segment(data, idx, 5000, 3000, device="cuda")
    torch.cuda.synchronize()

    ops = _device_ops(lambda: decode_stream_device(data, device="cuda",
                                                   window_blocks=25))
    assert dict(uc.launches) == {"unpack": 4}
    assert sc.launches["synth_fused"] == 4
    assert ops == 3 * 4 + 2
    got = []
    ops = _device_ops(lambda: got.append(read_segment(
        data, idx, 5000, 3000, device="cuda")))
    got = got[0]
    assert dict(uc.launches) == {"unpack": 1}
    assert ops == 4
    np.testing.assert_array_equal(
        got, read_segment(data, idx, 5000, 3000, backend="host"))


def test_unpack_kernel_rejects_bad_input():
    from libacm_tpu_torch.ops import unpack_cuda as uc

    dev = _card()
    wire = _bench().edge_wire("rows == 1")
    blob = torch.from_numpy(wire["blob"]).to(dev)
    kw = _bench().wire_args(wire)
    uc.reset_launches()
    with pytest.raises(ValueError, match="wire blob must be uint8"):
        st.unpack_cols_blob(blob[:-1], **kw)
    with pytest.raises(ValueError, match="wire blob must be uint8"):
        st.unpack_cols_blob(blob.to(torch.int16), **kw)
    with pytest.raises(ValueError, match="no unpack kernel for device meta"):
        st.unpack_cols_blob(blob.to("meta"), **kw)
    odd = dict(kw, lens=(3,) + tuple(kw["lens"][1:]))
    n = st.cols_blob_layout(kw["level"], kw["batch"], kw["nb"], odd["lens"],
                            has_wrap=True)[1]
    with pytest.raises(ValueError, match="even length"):
        st.unpack_cols_blob(torch.zeros(n, dtype=torch.uint8, device=dev),
                            **odd)
    assert sum(uc.launches.values()) == 0


# -- the masked checksum kernel (csrc/checksum.cu) ----------------------------


def _pcm_chunks(dev, seed, shapes, offsets, fill=None):
    """int16 PCM chunks [B, nb, L] on `dev`, each a view offsets[i] words
    into a larger buffer, and n_good per row (0, nb and partial in turn),
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    pcms, ngs = [], []
    for (B, nb, L), off in zip(shapes, offsets):
        data = (np.full((B, nb, L), fill, np.int16) if fill is not None
                else rng.integers(-32768, 32768, (B, nb, L)).astype(np.int16))
        buf = torch.zeros(off + data.size, dtype=torch.int16, device=dev)
        pcm = buf[off:].view(B, nb, L)
        pcm.copy_(torch.from_numpy(data))
        pcms.append(pcm)
        ngs.append(np.array([(0, nb, int(rng.integers(0, nb + 1)))[j % 3]
                             for j in range(B)], np.int64))
    return pcms, ngs


@pytest.mark.parametrize("shapes,offsets", [
    ([(25, 320, 2048)], [0]),  # a 7/16 corpus chunk
    ([(5, 416, 2048)], [0]),  # level 0, rows 2048
    ([(3, 5, 3)], [1]),  # level 0, rows 3: odd L, odd nb*L
    ([(4, 7, 3), (2, 9, 40), (3, 4, 256)], [3, 2, 7]),
    ([(2, 3, 1)], [5]),
    ([(3, 2, 1 << 15)], [6]),  # rows over several tiles, unaligned
])
def test_checksum_kernel_matches_plain(shapes, offsets):
    from libacm_tpu_torch.ops import checksum_cuda as cc

    dev = _card()
    pcms, ngs = _pcm_chunks(dev, len(shapes) * 7 + offsets[0], shapes,
                            offsets)
    cc.reset_launches()
    got = int(cc.sum_all(pcms, ngs).item())
    assert dict(cc.launches) == {"checksum": 1}
    want = int(cc.sum_all_plain(pcms, ngs).item()) & 0xFFFFFFFF
    assert got == want
    cpu = int(cc.sum_all_plain([p.cpu() for p in pcms], ngs)) & 0xFFFFFFFF
    assert got == cpu


def test_checksum_kernel_wraps_past_2_31():
    from libacm_tpu_torch.ops import checksum_cuda as cc

    dev = _card()
    pcms, ngs = _pcm_chunks(dev, 0, [(3, 7, 5000)], [1], fill=32767)
    ngs = [np.array([7, 7, 7])]
    assert int(cc.sum_all(pcms, ngs).item()) == (105_000 * 32767) & 0xFFFFFFFF


def test_checksum_no_good_row_launches_nothing():
    from libacm_tpu_torch.ops import checksum_cuda as cc

    dev = _card()
    pcms, _ = _pcm_chunks(dev, 1, [(2, 4, 16)], [0])
    cc.reset_launches()
    assert int(cc.sum_all(pcms, [np.zeros(2, np.int64)]).item()) == 0
    assert sum(cc.launches.values()) == 0


def test_checksum_one_launch_a_device_and_three_operations():
    """checksum() over a corpus sharded over [cuda:0, cuda:0]: one launch
    (one device), exactly three device operations under the profiler (the
    table's copy, the launch, the scalar's fetch), equal to one device's
    and to the CPU's."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import checksum_cuda as cc
    from libacm_tpu_torch.parallel import decode_corpus_device

    _card()
    rng = np.random.default_rng(31)
    files = [testing.speech_acm_bytes(rng, level=int(rng.choice([0, 4, 7])),
                                      rows=int(rng.choice([3, 16])),
                                      n_blocks=int(rng.integers(2, 9)))
             for _ in range(17)]
    files[3] = files[3][: len(files[3]) // 2]
    want = decode_corpus_device(files, device="cpu", chunk_files=3).checksum()
    one = decode_corpus_device(files, device="cuda", chunk_files=3)
    two = decode_corpus_device(files, devices=["cuda:0", "cuda:0"],
                               chunk_files=3).block_until_ready()
    assert one.checksum() == want
    got = []
    ops = _device_ops(lambda: got.append(two.checksum()))
    assert set(got) == {want}
    assert dict(cc.launches) == {"checksum": 1}
    assert ops == 3


def test_checksum_kernel_rejects_bad_input():
    from libacm_tpu_torch.ops import checksum_cuda as cc

    dev = _card()
    pcm = torch.zeros((2, 3, 8), dtype=torch.int16, device=dev)
    ng = np.array([3, 1])
    cc.reset_launches()
    with pytest.raises(ValueError, match="int16"):
        cc.sum_all([pcm.to(torch.int32)], [ng])
    with pytest.raises(ValueError, match="contiguous"):
        cc.sum_all([pcm.transpose(1, 2).contiguous().transpose(1, 2)], [ng])
    with pytest.raises(ValueError, match="one device a call"):
        cc.sum_all([pcm, pcm.cpu()], [ng, ng])
    with pytest.raises(ValueError, match="n_good must have 2 entries"):
        cc.sum_all([pcm], [np.array([1, 2, 3])])
    assert sum(cc.launches.values()) == 0


# -- the width-class block unpack kernel (csrc/unpack_blocks.cu) --------------


def _packed_on(dev, seed, nb, rows, cols, offsets=(0, 0, 0), pad=True):
    """(k int16 [nb, rows, cols] of mixed width classes, the six packed
    tensors on dev) from a numpy seed; p4, p8 and p16 are views offsets[i]
    elements into larger buffers."""
    from libacm_tpu_torch.ops import packing

    rng = np.random.default_rng(seed)
    k = np.zeros((nb, rows, cols), np.int16)
    for i in range(nb):
        s = int(rng.choice([8, 128, 32768]))
        k[i] = rng.integers(-s, s, (rows, cols))
    pads = (tuple(-(-c // 64) * 64 for c in packing.class_counts(k))
            if pad else None)
    pk = packing.pack_blocks(k, pad_to=pads)
    out = []
    for f, off in zip(("p4", "p8", "p16"), offsets):
        a = torch.from_numpy(getattr(pk, f))
        buf = torch.zeros(off + a.numel(), dtype=a.dtype, device=dev)
        v = buf[off:].view(a.shape)
        v.copy_(a)
        out.append(v)
    out += [torch.from_numpy(getattr(pk, f)).to(dev)
            for f in ("idx4", "idx8", "idx16")]
    return k, out


@pytest.mark.parametrize("nb,rows,cols,offsets,pad", [
    (7500, 16, 128, (0, 0, 0), False),  # 25 files of 7/16: a corpus chunk
    (300, 40, 16, (0, 0, 0), True),
    (13, 3, 1, (1, 3, 2), True),  # odd n: rows off 16 bytes
    (17, 5, 8, (3, 5, 7), False),
    (6, 3, 512, (2, 1, 1), True),  # blocks over 1,024 words
    (3, 16, 1 << 15, (0, 0, 0), False),  # 15/16: 64 CTAs a block
    (9, 33, 512, (1, 2, 3), False),
])
def test_unpack_blocks_kernel_matches_plain(nb, rows, cols, offsets, pad):
    from libacm_tpu_torch.ops import packing
    from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc

    dev = _card()
    k, t = _packed_on(dev, nb + rows, nb, rows, cols, offsets, pad)
    ubc.reset_launches()
    got = packing.unpack_blocks(*t, nb=nb, rows=rows, cols=cols)
    torch.cuda.synchronize()
    assert dict(ubc.launches) == {"unpack_blocks": 1}
    assert got.device == dev and got.dtype == torch.int16
    want = packing.unpack_blocks_plain(*t, nb=nb, rows=rows, cols=cols)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), k)


def test_unpack_blocks_kernel_skips_padding_and_leaves_zeros():
    from libacm_tpu_torch.ops import packing
    from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc

    dev = _card()
    k, t = _packed_on(dev, 5, 40, 4, 8)
    t[5] = t[5].clone()
    gone = int(t[5][0])
    assert gone < 40  # the seed has 16-bit blocks
    t[5][0] = 40 + 9  # past the padding slot: names no block
    got = ubc.unpack_blocks(*t, nb=40, rows=4, cols=8).cpu().numpy()
    k[gone] = 0
    np.testing.assert_array_equal(got, k)
    empty = [x[:0] for x in t]  # no packed row: one launch writes zeros
    ubc.reset_launches()
    assert not ubc.unpack_blocks(*empty, nb=40, rows=4, cols=8).any()
    assert dict(ubc.launches) == {"unpack_blocks": 1}
    ubc.reset_launches()  # no word to write: no launch
    assert ubc.unpack_blocks(*t, nb=0, rows=4, cols=8).shape == (0, 4, 8)
    assert sum(ubc.launches.values()) == 0


def test_unpack_blocks_one_launch_and_one_operation():
    """An unpack_blocks call on the card: exactly one device operation
    under the profiler (the kernel: no fill, no memset), one launch."""
    from libacm_tpu_torch.ops import packing
    from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc

    dev = _card()
    k, t = _packed_on(dev, 8, 300, 16, 128)
    kw = dict(nb=300, rows=16, cols=128)
    packing.unpack_blocks(*t, **kw)  # built and loaded, scratch made
    got = []
    ops = _device_ops(lambda: got.append(packing.unpack_blocks(*t, **kw)))
    assert dict(ubc.launches) == {"unpack_blocks": 1}
    assert ops == 1
    np.testing.assert_array_equal(got[0].cpu().numpy(), k)


@pytest.mark.parametrize("name", [
    "a negative index wraps onto a block", "-1 names row nb: dropped",
    "below -(nb + 1): dropped", "above nb: dropped",
    "a 4-bit and an 8-bit row name one block",
    "an 8-bit and a 16-bit row name one block"])
def test_unpack_blocks_kernel_follows_the_index_rules(name):
    """Indices pack_blocks never makes, as the CPU tests hold the plain
    version to the JAX package on them: the kernel equals the plain
    version; the block the changed row named before is zeros, or, where
    the new index wraps onto that block, the row's values."""
    from libacm_tpu_torch.ops import packing
    from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc

    dev = _card()
    nb = 60
    _, t = _packed_on(dev, 77, nb, 16, 128, offsets=(1, 3, 2), pad=False)
    assert min(x.shape[0] for x in t[3:]) >= 2
    f, new = {
        "a negative index wraps onto a block": (4, lambda i: i - nb - 1),
        "-1 names row nb: dropped": (5, lambda i: -1),
        "below -(nb + 1): dropped": (3, lambda i: -nb - 2),
        "above nb: dropped": (5, lambda i: nb + 1),
        "a 4-bit and an 8-bit row name one block": (3, lambda i: int(t[4][1])),
        "an 8-bit and a 16-bit row name one block": (4,
                                                     lambda i: int(t[5][1])),
    }[name]
    t[f] = t[f].clone()
    old = int(t[f][0])
    t[f][0] = new(old)
    kw = dict(nb=nb, rows=16, cols=128)
    ubc.reset_launches()
    got = packing.unpack_blocks(*t, **kw)
    want = packing.unpack_blocks_plain(*t, **kw)
    assert dict(ubc.launches) == {"unpack_blocks": 1}
    assert torch.equal(got, want)
    assert bool(want[old].any()) == ("wraps" in name)


def test_unpack_blocks_kernel_50_calls_in_a_row():
    """One scratch, 50 calls queued back to back (epochs, tickets and the
    stamp count run on across them), alternating a 7/16 chunk and a call
    with fewer blocks, some of them unnamed (owner words of the earlier
    epochs must read as unnamed) and the rest named through the wrap:
    each result equals the plain version."""
    from libacm_tpu_torch.ops import packing
    from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc

    dev = _card()
    _, big = _packed_on(dev, 50, 2000, 16, 128)
    _, small = _packed_on(dev, 51, 1500, 16, 128)
    small[3] = torch.full_like(small[3], 1500)  # 4-bit rows: padding
    small[4] = -small[4] - 2  # 8-bit rows: named by the wrap
    calls = [(big, 2000), (small, 1500)] * 25
    ubc.reset_launches()
    got = [packing.unpack_blocks(*t, nb=nb, rows=16, cols=128)
           for t, nb in calls]
    torch.cuda.synchronize()
    assert dict(ubc.launches) == {"unpack_blocks": 50}
    wants = [packing.unpack_blocks_plain(*t, nb=nb, rows=16, cols=128)
             for t, nb in calls[:2]]
    for i, g in enumerate(got):
        assert torch.equal(g, wants[i % 2]), i
    assert (wants[1].reshape(1500, -1) == 0).all(1).any()  # unnamed


def test_dense_route_packed_on_the_card(monkeypatch):
    """pack=True without the scanner: one unpack_blocks launch a chunk,
    results equal to the host decoder, checksum equal to the cols-wire
    route's."""
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc
    from libacm_tpu_torch.parallel import (decode_corpus_device,
                                           decode_corpus_host)
    from libacm_tpu_torch.scan import native

    _card()
    rng = np.random.default_rng(41)
    files = [testing.speech_acm_bytes(rng, level=lv, rows=rw, n_blocks=6)
             for lv, rw in ((7, 16), (7, 16), (0, 3), (4, 40), (2, 5))]
    cols = decode_corpus_device(files, device="cuda").checksum()
    monkeypatch.setattr(native, "available", lambda: False)
    ubc.reset_launches()
    dc = decode_corpus_device(files, device="cuda", chunk_files=2)
    dc.block_until_ready()
    assert ubc.launches["unpack_blocks"] == len(dc._buckets)
    assert dc.checksum() == cols
    for h, g in zip(decode_corpus_host(files), dc.to_results()):
        assert (h.status, h.filler_words) == (g.status, g.filler_words)
        np.testing.assert_array_equal(h.pcm, g.pcm)


def test_unpack_blocks_kernel_rejects_bad_input():
    from libacm_tpu_torch.ops import packing
    from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc

    dev = _card()
    _, t = _packed_on(dev, 6, 10, 4, 8)
    kw = dict(nb=10, rows=4, cols=8)
    ubc.reset_launches()
    with pytest.raises(ValueError, match="p16 must be torch.int16"):
        packing.unpack_blocks(*t[:2], t[2].to(torch.int32), *t[3:], **kw)
    with pytest.raises(ValueError, match="p8 must be torch.int8 of shape"):
        packing.unpack_blocks(t[0], t[1][:, :-1].contiguous(), *t[2:], **kw)
    with pytest.raises(ValueError, match="idx4 must be int32"):
        packing.unpack_blocks(*t[:3], t[3].long(), *t[4:], **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        packing.unpack_blocks(t[0].cpu(), *t[1:], **kw)
    assert sum(ubc.launches.values()) == 0
