"""The width-class block unpack: the port's plain version and a model of
the CUDA kernel (csrc/unpack_blocks.cu) ≡ the JAX package's
`unpack_blocks`, tolerance 0, on blocks made from numpy seeds and on the
indices `pack_blocks` never makes but the function takes.

`_kernel_model` replays the kernel's one launch on the host, on the
wrapper's own scratch (`ops.unpack_blocks_cuda._Scratch`, on the CPU):
the CTAs of `plan` take their tickets from word 0; stamp tickets do an
atomicMax of (epoch << 40 | packed row) on their blocks' owner words and
count themselves done in word DONE; output tickets wait for that count
and write their pass of PASS words of the flat output, each group of 8
words from its block's owner row (one 16-, 8- or
4-byte load and the kernel's shifts where the input is aligned, else
word by word) or as zeros. CTAs run in ticket order, or a few resident
at a time in a shuffled order of start and completion, an output CTA
spinning until the stamps are done. Every word must be written exactly
once. Change it with the kernel.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from libacm_tpu.ops import packing as jpacking
from libacm_tpu_torch.ops import packing as tpacking
from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc
from libacm_tpu_torch.ops import unpack_cuda

FIELDS = ("p4", "p8", "p16", "idx4", "idx8", "idx16")
CPU = torch.device("cpu")
U32 = (1 << 32) - 1


def _blocks(seed, nb, rows, cols, classes="mixed"):
    """int16 [nb, rows, cols] whose blocks fall in the 4-, 8- and 16-bit
    classes by a numpy seed ("mixed"), or all in one ("4", "8", "16")."""
    rng = np.random.default_rng(seed)
    span = {"4": [8], "8": [128], "16": [32768],
            "mixed": [8, 128, 32768]}[classes]
    k = np.zeros((nb, rows, cols), np.int16)
    for i in range(nb):
        s = int(rng.choice(span))
        k[i] = rng.integers(-s, s, (rows, cols))
        k[i].reshape(-1)[int(rng.integers(0, rows * cols))] = s - 1
    return k


def _packed(k, pad=True):
    pads = (tuple(-(-c // 64) * 64 for c in tpacking.class_counts(k))
            if pad else None)
    pt = tpacking.pack_blocks(k, pad_to=pads)
    pj = jpacking.pack_blocks(k, pad_to=pads)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f))
    return pt


def _jax_unpack(pk):
    out = jpacking.unpack_blocks(*(getattr(pk, f) for f in FIELDS),
                                 nb=pk.nb, rows=pk.rows, cols=pk.cols)
    return np.asarray(out)


def _plain(pk):
    t = [torch.from_numpy(np.ascontiguousarray(getattr(pk, f)))
         for f in FIELDS]
    return tpacking.unpack_blocks_plain(*t, nb=pk.nb, rows=pk.rows,
                                        cols=pk.cols).numpy()


def _signed(x, bits):
    """Two's complement of the low `bits` bits of x, as C's (int)(u <<
    (32 - bits)) >> (32 - bits) gives it."""
    x = np.asarray(x, np.int64) & ((1 << bits) - 1)
    return np.where(x >= 1 << (bits - 1), x - (1 << bits), x)


def _u32(buf, off):
    """The little-endian uint32s at byte offsets `off` of a uint8 buffer."""
    return sum(buf[off + j].astype(np.int64) << (8 * j) for j in range(4))


def _shifted(x, j, bits):
    """(int)(x << (32 - bits - bits*j)) >> (32 - bits): the kernel's
    extraction of field j of a uint32."""
    return _signed((x << (32 - bits - bits * j)) >> (32 - bits), bits)


class _Launch:
    """One call's kernel state on the host: the packed tensors as byte
    buffers with their addresses, the scratch's words, the plan."""

    def __init__(self, pk, s, addrs):
        self.nb, self.n = pk.nb, pk.rows * pk.cols
        self.half = (self.n + 1) // 2
        self.n4, self.n8, self.n16 = (len(pk.idx4), len(pk.idx8),
                                      len(pk.idx16))
        self.bufs = [np.ascontiguousarray(getattr(pk, f)).view(np.uint8)
                     .reshape(-1) for f in ("p4", "p8", "p16")]
        self.idx = np.concatenate([pk.idx4, pk.idx8, pk.idx16]).astype(
            np.int64)
        self.addrs = addrs
        self.words = s.words.numpy().view(np.uint64)
        self.epoch = np.uint64(s.epoch)
        self.ticket0, self.done0 = s.tickets & U32, s.done & U32
        self.p = ubc.plan(self.n4, self.n8, self.n16, self.n, self.nb)
        self.out = np.full(self.p["total"], 0x5A5A, np.int16)  # torch.empty
        self.written = np.zeros(self.p["total"], np.int64)
        self.modes = dict.fromkeys(("zero", "16", "8", "4", "slow",
                                    "cached passes"), 0)

    def ticket(self):
        """atomicAdd on the low 32 bits of word 0, less ticket0."""
        w = int(self.words[0])
        self.words[0] = np.uint64((w & ~U32) | ((w + 1) & U32))
        return ((w & U32) - self.ticket0) & U32

    def stamped(self):
        return ((int(self.words[ubc.DONE]) & U32) - self.done0) & U32

    def stamp(self, t, rng):
        r = t * ubc.THREADS + np.arange(ubc.THREADS)
        r = r[r < len(self.idx)]
        if rng is not None:
            r = rng.permutation(r)  # the atomics land in any order
        for row in r:
            i = int(self.idx[row])
            b = i + self.nb + 1 if i < 0 else i
            if 0 <= b < self.nb:
                own = np.uint64(int(self.epoch) << ubc.EPOCH_SHIFT | int(row))
                o = ubc.OWNERS + b
                self.words[o] = max(self.words[o], own)
        w = int(self.words[ubc.DONE])
        self.words[ubc.DONE] = np.uint64((w & ~U32) | ((w + 1) & U32))

    def source(self, own):
        """(class, row within its class, row's first byte) of owner words."""
        r = (own & np.uint64((1 << ubc.EPOCH_SHIFT) - 1)).astype(np.int64)
        c = np.where(r < self.n4, 0, np.where(r < self.n4 + self.n8, 1, 2))
        i = r - np.where(c == 0, 0, np.where(c == 1, self.n4,
                                             self.n4 + self.n8))
        first = np.where(c == 0, i * self.half,
                         np.where(c == 1, i * self.n, 2 * i * self.n))
        return c, i, first

    def words_at(self, w):
        """The kernel's word_at(), word by word: the owner row's word or 0."""
        b = w // self.n
        own = self.words[ubc.OWNERS + b]
        named = (own >> np.uint64(ubc.EPOCH_SHIFT)) == self.epoch
        c, _, first = self.source(own)
        o = w - b * self.n
        v = np.zeros(len(w), np.int64)
        for cls in range(3):
            m = named & (c == cls)
            if not m.any():
                continue
            buf = self.bufs[cls]
            if cls == 2:
                off = first[m] + 2 * o[m]
                v[m] = _signed(buf[off].astype(np.int64)
                               | buf[off + 1].astype(np.int64) << 8, 16)
            elif cls == 1:
                v[m] = _signed(buf[first[m] + o[m]], 8)
            else:
                byte = buf[first[m] + (o[m] >> 1)].astype(np.int64)
                v[m] = np.where(o[m] & 1, _signed(byte >> 4, 4),
                                _signed(byte, 4))
        return v

    def write_pass(self, u):
        p = u * ubc.PASS
        hi = min(p + ubc.PASS, self.p["total"])
        w = p + 8 * np.arange(ubc.PASS // 8, dtype=np.int64)
        w = w[w < hi]  # groups j * THREADS + tid, in any order
        b = w // self.n
        o = w - b * self.n
        # the owner words of the pass's blocks: read once into shared
        # memory where the pass spans at most OWN_CACHE blocks, else a
        # group at a time (the same words either way)
        last = (hi - 1) // self.n
        self.modes["cached passes"] += last - p // self.n < ubc.OWN_CACHE
        own = self.words[ubc.OWNERS + b]
        named = (own >> np.uint64(ubc.EPOCH_SHIFT)) == self.epoch
        c, _, first = self.source(own)
        slow = (w + 8 > hi) | (o + 8 > self.n)
        a4, a8, a16 = self.addrs
        vec = {2: (a16 + first + 2 * o) % 16 == 0,
               1: (a8 + first + o) % 8 == 0,
               0: ((o & 1) == 0) & ((a4 + first + (o >> 1)) % 4 == 0)}
        mode = np.where(slow, -2, np.where(~named, -1, c))
        for cls, ok in vec.items():
            mode[(mode == cls) & ~ok] = -2
        rows = np.zeros((len(w), 8), np.int64)
        for cls in range(3):
            m = mode == cls
            if not m.any():
                continue
            buf = self.bufs[cls]
            if cls == 2:  # one 16-byte load
                off = first[m] + 2 * o[m]
                lo16 = [buf[off + 2 * j].astype(np.int64)
                        | buf[off + 2 * j + 1].astype(np.int64) << 8
                        for j in range(8)]
                rows[m] = np.stack([_signed(x, 16) for x in lo16], 1)
            elif cls == 1:  # one 8-byte load: two words, four shifts
                x = _u32(buf, first[m] + o[m])
                y = _u32(buf, first[m] + o[m] + 4)
                rows[m] = np.stack([_shifted(x, j, 8) for j in range(4)]
                                   + [_shifted(y, j, 8)
                                      for j in range(4)], 1)
            else:  # one 4-byte load: eight nibble shifts
                x = _u32(buf, first[m] + (o[m] >> 1))
                rows[m] = np.stack([_shifted(x, j, 4)
                                    for j in range(8)], 1)
        fast = mode != -2
        assert (w[fast] % 8 == 0).all(), "unaligned 16-byte store"
        idx = w[fast][:, None] + np.arange(8)
        self.out[idx] = rows[fast]
        self.written[idx] += 1
        for name, m in (("zero", mode == -1), ("16", mode == 2),
                        ("8", mode == 1), ("4", mode == 0),
                        ("slow", mode == -2)):
            self.modes[name] += int(m.sum())
        ws = (w[mode == -2][:, None] + np.arange(8)).reshape(-1)
        ws = ws[ws < hi]
        self.out[ws] = self.words_at(ws)
        self.written[ws] += 1


def _kernel_model(pk, addrs=(0, 0, 0), order="ticket", seed=0,
                  stream=777):
    """The kernel's launch replayed on the host, on the scratch the
    wrapper keeps for (cpu, `stream`): (int16 [nb, rows, cols], words
    a group took each route, the plan). `addrs` are the byte addresses of
    p4, p8 and p16, taken modulo 16 (the alignment is all that they
    change); "shuffled" keeps 3 CTAs resident, started in a shuffled
    order, and steps a random one that is not spinning."""
    s = ubc._Scratch.take(CPU, stream, ubc.OWNERS + pk.nb)
    k = _Launch(pk, s, addrs)
    p = k.p
    rng = np.random.default_rng(seed) if order == "shuffled" else None
    start = (list(rng.permutation(p["grid"])) if rng is not None
             else list(range(p["grid"])))
    resident, finished = [], 0
    while finished < p["grid"]:
        while start and len(resident) < (3 if rng is not None
                                         else p["grid"]):
            start.pop(0)
            resident.append(k.ticket())
        ready = [t for t in resident
                 if t < p["nstamp"] or k.stamped() >= p["nstamp"]]
        assert ready, "every resident CTA spins: no forward progress"
        t = ready[int(rng.integers(len(ready)))] if rng is not None \
            else ready[0]
        resident.remove(t)
        if t < p["nstamp"]:
            k.stamp(t, rng)
        else:
            k.write_pass(t - p["nstamp"])
        finished += 1
    s.tickets += p["grid"]
    s.done += p["nstamp"]
    assert (k.written == 1).all(), "a word not written exactly once"
    return k.out.reshape(pk.nb, pk.rows, pk.cols), k.modes, p


@pytest.fixture(autouse=True)
def _own_scratch():
    """Each test starts on a scratch of its own (stream key 777)."""
    ubc._Scratch._by_key.pop((None, 777), None)
    yield
    ubc._Scratch._by_key.pop((None, 777), None)


@pytest.fixture
def small_ctas(monkeypatch):
    """CTAs of 2 threads and passes of 32 words: a small case is many
    stamp and output tickets, and blocks cross passes."""
    monkeypatch.setattr(ubc, "THREADS", 2)
    monkeypatch.setattr(ubc, "PASS", 32)


#: (seed, nb, rows, cols, classes, padded to multiples of 64)
CASES = {
    "7/16, mixed, padded": (1, 24, 16, 128, "mixed", True),
    "odd n (rows 3, level 0)": (2, 13, 3, 1, "mixed", True),
    "odd n (rows 5, level 3)": (3, 17, 5, 8, "mixed", False),
    "4-bit only (8- and 16-bit classes empty)": (4, 9, 4, 16, "4", True),
    "8-bit only": (5, 7, 9, 4, "8", False),
    "16-bit only, odd n": (6, 5, 7, 1, "16", True),
    "a block of more than 1,024 words": (7, 6, 3, 512, "mixed", True),
    "a block of several parts": (8, 3, 33, 512, "mixed", False),
    "one block": (9, 1, 16, 128, "mixed", False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax(name):
    seed, nb, rows, cols, classes, pad = CASES[name]
    k = _blocks(seed, nb, rows, cols, classes)
    pk = _packed(k, pad)
    t = [torch.from_numpy(getattr(pk, f)) for f in FIELDS]
    got = tpacking.unpack_blocks_plain(*t, nb=nb, rows=rows, cols=cols)
    np.testing.assert_array_equal(got.numpy(), _jax_unpack(pk))
    np.testing.assert_array_equal(got.numpy(), k)
    # the dispatcher takes the plain version for CPU tensors
    disp = tpacking.unpack_blocks(*t, nb=nb, rows=rows, cols=cols)
    assert torch.equal(disp, got) and sum(ubc.launches.values()) == 0


ADDRS = [(0, 0, 0), (1, 3, 2), (3, 5, 10)]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("addrs", ADDRS)
def test_kernel_model_matches_jax(name, addrs, small_ctas):
    """Every case at aligned and unaligned buffers, CTAs in ticket order."""
    _model_case(name, addrs, "ticket")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("addrs", ADDRS)
def test_kernel_model_shuffled_matches_jax(name, addrs, small_ctas):
    """Every case with CTAs in a shuffled order of start and completion."""
    _model_case(name, addrs, "shuffled")


def _model_case(name, addrs, order):
    seed, nb, rows, cols, classes, pad = CASES[name]
    k = _blocks(seed, nb, rows, cols, classes)
    pk = _packed(k, pad)
    got, modes, _ = _kernel_model(pk, addrs, order, seed=seed)
    np.testing.assert_array_equal(got, _jax_unpack(pk))
    if addrs == (0, 0, 0) and rows * cols % 8 == 0:
        assert modes["4"] + modes["8"] + modes["16"] > 0  # vector loads
    if rows * cols % 8:
        assert modes["slow"] > 0  # groups that cross a block


def test_kernel_model_at_the_real_chunk():
    """The kernel's constants: a 7/16 block is a quarter of an output
    ticket, and the bench chunk's plan."""
    assert (ubc.THREADS, ubc.PASS) == (256, 8192)
    p = ubc.plan(3520, 3980, 52, 2048, 7500)
    assert (p["nstamp"], p["units"], p["grid"]) == (30, 1875, 1905)
    assert ubc.plan(2, 1, 0, 0, 5)["grid"] == 0
    assert ubc.plan(2, 1, 0, 8, 0)["grid"] == 0
    assert ubc.plan(0, 0, 0, 8, 5) == {"nstamp": 0, "units": 1, "grid": 1,
                                       "total": 40, "rows": 0}
    k = _blocks(10, 12, 16, 128)
    pk = _packed(k)
    got, modes, p = _kernel_model(pk)
    np.testing.assert_array_equal(got, k)
    assert modes["slow"] == 0 and modes["zero"] == 0
    assert modes["cached passes"] == p["units"]  # one pass each


def test_kernel_constants_match_the_source():
    """THREADS, PASS and EPOCH_SHIFT of the wrapper are the kernel's."""
    src = (pathlib.Path(ubc.__file__).resolve().parent.parent / "csrc"
           / "unpack_blocks.cu").read_text()
    const = {m[0]: m[1] for m in re.findall(
        r"constexpr int (\w+) = (\w+);", src)}
    assert int(const["THREADS"]) == ubc.THREADS
    assert int(const["THREADS"]) * 8 * int(const["G"]) == ubc.PASS
    assert int(const["EPOCH_SHIFT"]) == ubc.EPOCH_SHIFT
    assert (int(const["DONE"]), int(const["OWNERS"])) == (ubc.DONE,
                                                          ubc.OWNERS)
    assert int(const["OWN_CACHE"]) == ubc.OWN_CACHE
    assert ubc.EPOCH_SHIFT + unpack_cuda.EPOCHS.bit_length() - 1 == 64


def test_kernel_model_a_15_16_row():
    """15/16 blocks of 524,288 words at the real constants: 64 output
    tickets a block, 16-byte groups from each class."""
    k = _blocks(13, 3, 16, 1 << 15)
    pk = _packed(k, pad=False)
    got, modes, p = _kernel_model(pk, order="shuffled", seed=13)
    assert p["units"] == 3 * 64 and p["nstamp"] == 1
    np.testing.assert_array_equal(got, _jax_unpack(pk))
    np.testing.assert_array_equal(got, k)
    assert modes["slow"] == 0 and modes["zero"] == 0
    assert modes["cached passes"] == p["units"]


def _malformed(name):
    """PackedBlocks of 6 seeded 4x8 blocks (all three classes, not padded)
    with one idx changed as `name` says, and the block it named before."""
    k = _blocks(21, 6, 4, 8)
    pk = _packed(k, pad=False)
    assert min(len(pk.idx4), len(pk.idx8), len(pk.idx16)) >= 1
    f, new = {
        "a negative index wraps onto a block": ("idx8", lambda i: i - 7),
        "-1 names row nb: dropped": ("idx16", lambda i: -1),
        "below -(nb + 1): dropped": ("idx4", lambda i: -8),
        "above nb: dropped": ("idx16", lambda i: 7),
        "a 4-bit and an 8-bit row name one block":
            ("idx4", lambda i: int(pk.idx8[0])),
        "an 8-bit and a 16-bit row name one block":
            ("idx8", lambda i: int(pk.idx16[0])),
    }[name]
    a = getattr(pk, f).copy()
    old = int(a[0])
    a[0] = new(old)
    setattr(pk, f, a)
    return pk, old


MALFORMED = ["a negative index wraps onto a block",
             "-1 names row nb: dropped", "below -(nb + 1): dropped",
             "above nb: dropped", "a 4-bit and an 8-bit row name one block",
             "an 8-bit and a 16-bit row name one block"]


@pytest.mark.parametrize("name", MALFORMED)
def test_index_rules_match_jax(name, small_ctas):
    """Indices pack_blocks never makes: the plain version and the model
    (in ticket order and shuffled) equal the JAX package's unpack_blocks,
    which scatters into nb + 1 rows, class after class, and drops row
    nb. (A new index names a block no other row of its class names: two
    rows of one class on one block are outside the contract.)"""
    pk, old = _malformed(name)
    want = _jax_unpack(pk)
    np.testing.assert_array_equal(_plain(pk), want)
    for order in ("ticket", "shuffled"):
        got, _, _ = _kernel_model(pk, order=order, seed=len(name))
        np.testing.assert_array_equal(got, want)
    # the block the row named is unnamed now, or named again by the wrap
    assert bool(want[old].any()) == ("wraps" in name)


def test_indices_out_of_range_write_nothing():
    """Padding (idx == nb), idx above nb and a negative idx, against the
    JAX package: idx16[0] = nb + 5 names no block and leaves its block
    zero; idx8[0] below 0 names block idx + nb + 1 (a scatter into nb + 1
    rows wraps it once), here a 4-bit block, where the 8-bit row wins,
    and the 8-bit row's own block is left zero."""
    k = _blocks(11, 10, 4, 8)
    pk = _packed(k)
    b4 = int(pk.idx4[0])  # a block of the 4-bit class
    gone = [int(pk.idx16[0]), int(pk.idx8[0])]
    assert max(gone) < pk.nb and b4 not in gone
    pk.idx16 = pk.idx16.copy()
    pk.idx16[0] = pk.nb + 5
    pk.idx8 = pk.idx8.copy()
    pk.idx8[0] = b4 - pk.nb - 1
    want = _jax_unpack(pk)
    assert not want[gone].any()  # named by no row: zeros
    np.testing.assert_array_equal(want[b4], k[gone[1]])  # the 8-bit row
    np.testing.assert_array_equal(_plain(pk), want)
    got, _, _ = _kernel_model(pk)
    np.testing.assert_array_equal(got, want)


def test_two_calls_on_one_scratch(small_ctas):
    """A second call with fewer blocks on the first call's scratch: the
    owner words the first call stamped are of an earlier epoch, so the
    blocks the second call leaves unnamed read as zeros."""
    first = _packed(_blocks(30, 24, 4, 8))
    np.testing.assert_array_equal(_kernel_model(first)[0],
                                  _jax_unpack(first))
    k = _blocks(31, 10, 4, 8)
    pk = _packed(k)
    for f in ("idx4", "idx8"):  # blocks of these classes: unnamed now
        setattr(pk, f, np.full_like(getattr(pk, f), pk.nb))
    s = ubc._Scratch._by_key[(None, 777)]
    assert s.epoch == 1 and s.tickets and s.done
    got, modes, _ = _kernel_model(pk, order="shuffled", seed=2)
    want = _jax_unpack(pk)
    np.testing.assert_array_equal(got, want)
    assert s.epoch == 2 and modes["zero"] > 0


def test_epoch_and_counter_wrap(small_ctas):
    """Epochs wrap: the buffer is zeroed and the counters start again.
    The ticket and done counters are 32-bit and wrap on their own: a call
    whose tickets cross 2^32 still waits and writes right."""
    k = _blocks(40, 16, 4, 8)
    pk = _packed(k)
    s = ubc._Scratch.take(CPU, 777, ubc.OWNERS + pk.nb)
    s.epoch = unpack_cuda.EPOCHS - 2  # the model takes EPOCHS - 1
    s.tickets = s.done = (1 << 32) - 3
    words = s.words.numpy().view(np.uint64)
    words[0] = words[ubc.DONE] = (1 << 32) - 3
    words[ubc.OWNERS:] = np.uint64((unpack_cuda.EPOCHS - 2) << ubc.EPOCH_SHIFT)
    got, _, p = _kernel_model(pk, order="shuffled", seed=4)
    np.testing.assert_array_equal(got, k)
    assert p["grid"] > 3 and p["nstamp"] > 3  # both counters wrapped
    assert int(s.words[0]) & U32 == (p["grid"] - 3) & U32
    got, _, _ = _kernel_model(pk, seed=5)  # epoch EPOCHS: the wrap
    assert (s.epoch, s.tickets, s.done) == (1, p["grid"], p["nstamp"])
    np.testing.assert_array_equal(got, k)


def test_no_block_and_no_packed_row(small_ctas):
    """nb = 0 is no launch and an empty result; no packed row is one
    launch of output tickets alone, every block zero, as JAX gives."""
    pk = _packed(_blocks(50, 0, 4, 8), pad=False)
    got, _, p = _kernel_model(pk)
    assert p["grid"] == 0 and got.shape == (0, 4, 8)
    assert _jax_unpack(pk).shape == (0, 4, 8)
    pk = _packed(_blocks(51, 7, 4, 8), pad=False)
    for f in FIELDS:
        setattr(pk, f, getattr(pk, f)[:0])
    got, modes, p = _kernel_model(pk, order="shuffled", seed=1)
    assert p["nstamp"] == 0 and p["units"] == 7
    np.testing.assert_array_equal(got, _jax_unpack(pk))
    np.testing.assert_array_equal(_plain(pk), np.zeros((7, 4, 8)))
    assert modes["zero"] == 7 * 4 * 8 // 8


def test_wrapper_rejects_what_the_kernel_does_not_take():
    k = _blocks(12, 6, 4, 8)
    pk = _packed(k)
    t = {f: torch.from_numpy(getattr(pk, f)) for f in FIELDS}
    kw = dict(nb=pk.nb, rows=pk.rows, cols=pk.cols)
    with pytest.raises(ValueError, match="no unpack_blocks kernel for device"):
        tpacking.unpack_blocks(*(t[f].to("meta") for f in FIELDS), **kw)
    with pytest.raises(ValueError, match="no unpack_blocks kernel for device"):
        ubc.unpack_blocks(*t.values(), **kw)
    assert sum(ubc.launches.values()) == 0


def test_kernel_model_passes_wider_than_the_owner_cache(small_ctas,
                                                       monkeypatch):
    """A pass that spans more blocks than the shared owner cache reads
    its owner words a group at a time: the same result."""
    monkeypatch.setattr(ubc, "OWN_CACHE", 2)
    k = _blocks(60, 30, 1, 3)  # n = 3: a pass of 32 words spans 11 blocks
    pk = _packed(k)
    got, modes, p = _kernel_model(pk, order="shuffled", seed=6)
    np.testing.assert_array_equal(got, _jax_unpack(pk))
    assert modes["cached passes"] == 0 and modes["slow"] > 0
