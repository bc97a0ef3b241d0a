"""The width-class block unpack: the port's plain version and a model of
the CUDA kernel (csrc/unpack_blocks.cu) ≡ the JAX package's
`unpack_blocks`, tolerance 0, on blocks made from numpy seeds.

`_kernel_model` replays the kernel's one launch on the host: the CTAs of
`ops.unpack_blocks_cuda.plan` (packed rows of the three classes in turn,
parts of CHUNK words), each CTA's head, 16-byte groups and tail at the
alignment given by the buffers' addresses, and each group's input as one
vector load where the input is aligned (the kernel's shifts) or word by
word. Change it with the kernel.
"""

import numpy as np
import pytest
import torch

from libacm_tpu.ops import packing as jpacking
from libacm_tpu_torch.ops import packing as tpacking
from libacm_tpu_torch.ops import unpack_blocks_cuda as ubc

FIELDS = ("p4", "p8", "p16", "idx4", "idx8", "idx16")


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


def _signed(x, bits):
    """Two's complement of the low `bits` bits of x, as C's (int)(u <<
    (32 - bits)) >> (32 - bits) gives it."""
    x = np.asarray(x, np.int64) & ((1 << bits) - 1)
    return np.where(x >= 1 << (bits - 1), x - (1 << bits), x)


def _value(c, row, w):
    """Word w of a packed row (a uint8 numpy view): the kernel's value()."""
    if c == 2:
        return int(_signed(int(row[2 * w]) | int(row[2 * w + 1]) << 8, 16))
    if c == 1:
        return int(_signed(row[w], 8))
    b = int(row[w >> 1])
    return int(_signed(b >> 4, 4)) if w & 1 else int(_signed(b, 4))


def _load8(c, row, addr, w):
    """Words w..w+7: one vector load and the kernel's shifts where the
    input address is aligned (16, 8 or 4 bytes), else word by word."""
    if c == 2 and (addr + 2 * w) % 16 == 0:
        x = row[2 * w: 2 * w + 16].view(np.uint16)
        return [int(_signed(v, 16)) for v in x], True
    if c == 1 and (addr + w) % 8 == 0:
        lo, hi = (int.from_bytes(row[w + 4 * h: w + 4 * h + 4].tobytes(),
                                 "little") for h in (0, 1))
        return ([int(_signed(lo >> (8 * j), 8)) for j in range(4)]
                + [int(_signed(hi >> (8 * j), 8)) for j in range(4)]), True
    if c == 0 and w % 2 == 0 and (addr + w // 2) % 4 == 0:
        x = int.from_bytes(row[w // 2: w // 2 + 4].tobytes(), "little")
        return [int(_signed(x >> (4 * j), 4)) for j in range(8)], True
    return [_value(c, row, w + j) for j in range(8)], False


def _kernel_model(pk, addrs=(0, 0, 0, 0)):
    """The kernel's launch replayed on the host: (int16 [nb, rows, cols],
    vector loads). `addrs` are the byte addresses of p4, p8, p16 and the
    output, taken modulo 16 (the alignment is all that they change)."""
    nb, n = pk.nb, pk.rows * pk.cols
    a4, a8, a16, ao = addrs
    assert a16 % 2 == 0 and ao % 2 == 0
    n4, n8, n16 = len(pk.idx4), len(pk.idx8), len(pk.idx16)
    splits, grid = ubc.plan(n4, n8, n16, n, nb)
    out = np.zeros((nb, n), np.int16)
    written = np.zeros((nb, n), np.int64)
    vectors = 0
    for cta in range(grid):
        r, part = divmod(cta, splits)
        if r < n4:
            c, i, idx = 0, r, int(pk.idx4[r])
            row = pk.p4[i].view(np.uint8)
            addr = a4 + i * ((n + 1) // 2)
        elif r < n4 + n8:
            c, i, idx = 1, r - n4, int(pk.idx8[r - n4])
            row, addr = pk.p8[i].view(np.uint8), a8 + i * n
        else:
            c, i, idx = 2, r - n4 - n8, int(pk.idx16[r - n4 - n8])
            row, addr = pk.p16[i].view(np.uint8), a16 + 2 * i * n
        if idx < 0 or idx >= nb:
            continue
        oaddr = ao + 2 * idx * n
        w0 = part * ubc.CHUNK
        w1 = min(w0 + ubc.CHUNK, n)
        wa = min(w0 + ((16 - (oaddr + 2 * w0) % 16) % 16) // 2, w1)
        groups = (w1 - wa) >> 3
        wb = wa + 8 * groups
        for w in list(range(w0, wa)) + list(range(wb, w1)):
            out[idx, w] = _value(c, row, w)
            written[idx, w] += 1
        for g in range(groups):
            w = wa + 8 * g
            assert (oaddr + 2 * w) % 16 == 0, "unaligned 16-byte store"
            vals, vec = _load8(c, row, addr, w)
            vectors += vec
            out[idx, w: w + 8] = vals
            written[idx, w: w + 8] += 1
    named = set(int(x) for x in np.concatenate(
        [pk.idx4, pk.idx8, pk.idx16]) if 0 <= x < nb)
    for b in range(nb):
        assert (written[b] == (1 if b in named else 0)).all(), b
    return out.reshape(nb, pk.rows, pk.cols), vectors


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


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("addrs", [(0, 0, 0, 0), (1, 3, 2, 6),
                                   (3, 5, 10, 14)])
def test_kernel_model_matches_jax(name, addrs, monkeypatch):
    """Every case at aligned and unaligned buffers; CHUNK cut to 24 words
    so that a block is several CTAs and their ranges start off 16 bytes."""
    monkeypatch.setattr(ubc, "CHUNK", 24)
    seed, nb, rows, cols, classes, pad = CASES[name]
    k = _blocks(seed, nb, rows, cols, classes)
    pk = _packed(k, pad)
    got, vectors = _kernel_model(pk, addrs)
    np.testing.assert_array_equal(got, _jax_unpack(pk))
    if addrs == (0, 0, 0, 0) and rows * cols % 8 == 0:
        assert vectors > 0  # aligned rows take the vector loads


def test_kernel_model_at_the_real_chunk():
    """CHUNK as the kernel has it: a 15/16 block (524,288 words) is 64
    CTAs; a 7/16 block one."""
    assert ubc.plan(3, 0, 2, 1 << 19, 5) == (64, 5 * 64)
    assert ubc.plan(0, 0, 0, 2048, 5) == (1, 0)
    assert ubc.plan(2, 1, 0, 0, 5) == (0, 0)
    assert ubc.plan(2, 1, 0, 8, 0) == (0, 0)
    k = _blocks(10, 12, 16, 128)
    pk = _packed(k)
    got, _ = _kernel_model(pk, (0, 0, 0, 0))
    np.testing.assert_array_equal(got, k)


def test_indices_out_of_range_write_nothing():
    """Padding (idx == nb) and idx > nb or < 0 name no block: the model
    skips them, and blocks no list names stay zero, as jnp.zeros leaves
    them."""
    k = _blocks(11, 10, 4, 8)
    pk = _packed(k)
    gone = []
    for f, bad in (("idx16", pk.nb + 5), ("idx8", -3)):
        a = getattr(pk, f).copy()
        if len(a) and a[0] < pk.nb:
            gone.append(int(a[0]))
            a[0] = bad
        setattr(pk, f, a)
    assert len(gone) == 2
    got, _ = _kernel_model(pk)
    want = k.copy()
    want[gone] = 0
    np.testing.assert_array_equal(got, want)


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
