"""The masked content digest: the port's plain version and a model of the
CUDA kernel (csrc/checksum.cu) ≡ the JAX package's `_sum_all`, tolerance
0, on inputs made from numpy seeds; and `DeviceCorpus.checksum()` on the
CPU ≡ the JAX package's on every device route and chunking.

`_kernel_model` replays the kernel on CPU tensors, through the real
addresses of `ops.checksum_cuda.row_spans` and the table of
`ops.checksum_cuda.plan`: tiles walked grid-strided by CTA, each tile's
span found by the kernel's binary search, head, 16-byte body vectors and
tail summed in uint32 with wrap. Change it with the kernel.
"""

import functools

import numpy as np
import pytest
import torch

from libacm_tpu import testing
from libacm_tpu.parallel import corpus as jcorpus
from libacm_tpu_torch.ops import checksum_cuda as cc
from libacm_tpu_torch.parallel import corpus as tcorpus

MASK = 0xFFFFFFFF


def _jax_sum(pcms, ngs) -> int:
    """libacm_tpu.parallel.corpus._sum_all, as DeviceCorpus.checksum
    calls it: (pcm, n_good) pairs, the int32 result & 0xFFFFFFFF."""
    import jax.numpy as jnp

    args = []
    for pcm, ng in zip(pcms, ngs):
        args += [jnp.asarray(pcm.numpy()), jnp.asarray(ng.astype(np.int32))]
    return int(jcorpus._sum_all(*args)) & MASK


def _chunks(seed, shapes, ng_kind, offsets=None, fill=None):
    """int16 PCM chunks [B, nb, L] from a numpy seed (or all `fill`), each
    a view `offsets[i]` words into a larger CPU buffer (so its rows start
    off a 16-byte boundary), with n_good per row: "zero", "partial",
    "full" or "mixed" (a row of each, in turn)."""
    rng = np.random.default_rng(seed)
    pcms, ngs = [], []
    for i, (B, nb, L) in enumerate(shapes):
        off = offsets[i] if offsets else 0
        data = (np.full((B, nb, L), fill, np.int16) if fill is not None
                else rng.integers(-32768, 32768, (B, nb, L)).astype(np.int16))
        buf = torch.zeros(off + data.size, dtype=torch.int16)
        pcm = buf[off:].view(B, nb, L)
        pcm.copy_(torch.from_numpy(data))
        kinds = {"zero": [0] * B, "full": [nb] * B,
                 "partial": list(rng.integers(1, max(nb, 2), B)),
                 "mixed": [(0, nb, int(rng.integers(0, nb + 1)))[j % 3]
                           for j in range(B)]}[ng_kind]
        pcms.append(pcm)
        ngs.append(np.minimum(np.asarray(kinds, np.int64), nb))
    return pcms, ngs


def _kernel_model(pcms, ngs, grid=7) -> int:
    """The kernel's walk over the table, on CPU tensors: returns the
    uint32 accumulator, after checking that every good word was summed
    once, no other word was, and every vector load was 16-byte aligned."""
    spans = [(int(a), int(n)) for pcm, ng in zip(pcms, ngs)
             for a, n in cc.row_spans(pcm, ng)]
    tab, nspans, ntiles = cc.plan(spans)
    if not nspans:
        return 0
    # address -> the word it names (each chunk's storage as a flat view)
    views = [(pcm.data_ptr(), pcm.reshape(-1)) for pcm in pcms]

    def words(addr, n):
        for base, flat in views:
            if base <= addr and addr + 2 * n <= base + 2 * flat.numel():
                i = (addr - base) // 2
                return flat[i: i + n].to(torch.int64)
        raise AssertionError(f"span {addr:#x}+{n} lies in no chunk")

    seen = {}

    def take(addr, n):
        for a in range(addr, addr + 2 * n, 2):
            seen[a] = seen.get(a, 0) + 1
        return int(words(addr, n).sum()) if n > 0 else 0

    span = tab[1:].reshape(nspans, cc.SPAN_WORDS)
    first = span[:, 3]
    acc = 0
    for cta in range(grid):
        for t in range(cta, ntiles, grid):
            lo, hi = 0, nspans - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if first[mid] <= t:
                    lo = mid
                else:
                    hi = mid - 1
            addr, n, head, t0 = (int(x) for x in span[lo])
            t_end = int(first[lo + 1]) if lo + 1 < nspans else ntiles
            nvec = (n - head) >> 3
            v0 = (t - t0) * cc.TILE_VECS
            v1 = min(v0 + cc.TILE_VECS, nvec)
            body = addr + 2 * head
            assert body % 16 == 0 or v1 <= v0, "unaligned vector load"
            if v1 > v0:
                acc += take(body + 16 * v0, 8 * (v1 - v0))
            if t == t0:
                acc += take(addr, head)
            if t == t_end - 1:
                tail0 = head + 8 * nvec
                acc += take(addr + 2 * tail0, n - tail0)
    want = {a for addr, n in spans for a in range(addr, addr + 2 * n, 2)}
    assert set(seen) == want and all(c == 1 for c in seen.values())
    return acc & MASK


#: (shapes [B, nb, L] of the chunks, n_good kind, word offsets of the
#: chunks in their buffers)
CASES = {
    "one chunk, full": ([(3, 5, 64)], "full", None),
    "one chunk, partial": ([(4, 6, 128)], "partial", None),
    "no good block": ([(2, 4, 32)], "zero", None),
    "rows of each kind": ([(6, 5, 16)], "mixed", None),
    "level 0, rows 3 (odd L)": ([(3, 5, 3)], "mixed", [1]),
    "odd nb*L, rows off 16 bytes": ([(4, 7, 3)], "full", [3]),
    "L = 1": ([(3, 9, 1)], "partial", [5]),
    "several chunks": ([(3, 4, 256), (2, 9, 40), (5, 3, 7)], "mixed",
                       [0, 2, 7]),
    "a row over one tile": ([(2, 3, 32768)], "full", [6]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_sum_matches_jax(name):
    shapes, kind, offsets = CASES[name]
    pcms, ngs = _chunks(len(name), shapes, kind, offsets)
    want = _jax_sum(pcms, ngs)
    assert int(cc.sum_all_plain(pcms, ngs)) & MASK == want
    assert int(cc.sum_all(pcms, ngs).item()) & MASK == want  # CPU: plain


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("tile_vecs", [4096, 3])
def test_kernel_model_matches_jax(name, tile_vecs, monkeypatch):
    """The kernel's table and walk; at tile_vecs 3 every span of more than
    24 words is several tiles."""
    monkeypatch.setattr(cc, "TILE_VECS", tile_vecs)
    shapes, kind, offsets = CASES[name]
    pcms, ngs = _chunks(len(name), shapes, kind, offsets)
    for grid in (1, 7):
        assert _kernel_model(pcms, ngs, grid) == _jax_sum(pcms, ngs)


def test_sum_that_wraps_past_2_31():
    """70,000 words of 32,767 (2,293,690,000 > 2^31): the int32 sum
    wraps in the JAX package, the uint32 one in the kernel."""
    pcms, ngs = _chunks(0, [(2, 7, 5000)], "full", [1], fill=32767)
    want = _jax_sum(pcms, ngs)
    assert want == (70_000 * 32767) & MASK
    assert int(cc.sum_all_plain(pcms, ngs)) & MASK == want
    assert _kernel_model(pcms, ngs) == want
    neg, ngs = _chunks(0, [(2, 7, 5000)], "full", [3], fill=-32768)
    assert _kernel_model(neg, ngs) == _jax_sum(neg, ngs)


def test_plan_heads_and_tiles():
    """Heads reach the next 16-byte boundary (never past the span), and
    every span has at least one tile."""
    tab, nspans, tiles = cc.plan([(0x1000, 100), (0x1006, 5), (0x2002, 0),
                                  (0x3002, 3 + 8 * 4096 + 1)])
    assert nspans == 3 and tab[0] == 0
    span = tab[1:].reshape(3, cc.SPAN_WORDS).tolist()
    assert span[0] == [0x1000, 100, 0, 0]
    assert span[1] == [0x1006, 5, 5, 1]  # the 5 words to the boundary: all
    assert span[2] == [0x3002, 8 * 4096 + 4, 7, 2]
    assert tiles == 3  # (32,772 - 7) >> 3 = 4,095 vectors: one tile
    with pytest.raises(ValueError, match="2-byte aligned"):
        cc.plan([(0x1001, 4)])


def test_wrapper_rejects_other_devices_and_mixes():
    pcm = torch.zeros((2, 3, 4), dtype=torch.int16)
    ng = np.array([3, 1])
    with pytest.raises(ValueError, match="no checksum kernel for device"):
        cc.sum_all([pcm.to("meta")], [ng])
    with pytest.raises(ValueError, match="1 chunks, 2 n_good"):
        cc.sum_all([pcm], [ng, ng])
    with pytest.raises(ValueError, match="at least one chunk"):
        cc.sum_all([], [])
    assert sum(cc.launches.values()) == 0


def _corpus():
    rng = np.random.default_rng(11)
    files = [testing.random_acm_bytes(rng, level=6, rows=16, n_blocks=4,
                                      max_pwr=13) for _ in range(4)]
    files += [testing.random_acm_bytes(rng, level=0, rows=3, n_blocks=5),
              testing.random_acm_bytes(rng, level=2, rows=5, n_blocks=7)]
    files.append(files[0][: len(files[0]) * 2 // 3])  # truncated member
    files.append(b"not an ACM stream")
    return files


@functools.lru_cache(maxsize=1)
def _jax_checksum() -> int:
    return jcorpus.decode_corpus_device(_corpus(), backend="jax").checksum()


@pytest.mark.parametrize("route", ["cols-wire", "dense pack=False",
                                   "dense pack=True"])
@pytest.mark.parametrize("chunk_files", [None, 2])
def test_corpus_checksum_matches_jax(route, chunk_files, monkeypatch):
    """DeviceCorpus.checksum() on the CPU (the plain version) ≡ the JAX
    package's, on each device route, for two chunkings; "dense pack=True"
    is the route taken without the C++ scanner (pack_blocks, then
    unpack_blocks on the device)."""
    from libacm_tpu_torch.scan import native as tnative

    if route == "dense pack=True":
        monkeypatch.setattr(tnative, "available", lambda: False)
    dc = tcorpus.decode_corpus_device(
        _corpus(), device="cpu", chunk_files=chunk_files,
        pack=route != "dense pack=False")
    assert dc.summary.n_failed == 1
    assert dc.checksum() == _jax_checksum()
    assert sum(cc.launches.values()) == 0  # no kernel on the CPU
