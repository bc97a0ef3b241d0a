"""The benchmark's files, made from a seed: each class's files are blocks drawn
from a seeded pool of encoded blocks, joined bit by bit behind a fresh
header.

Encoding is the slow part (a few hundred blocks a second), so each class
encodes `pool_blocks` blocks once (`make_pool`) and every file of the class
is a seeded draw of them (`compose`). ACM blocks carry no framing and no
alignment: a block's coefficients depend on its own bits alone, so any
sequence of pool blocks behind a header that counts them is a valid
stream; each junction gives the filterbank another carry. Every file is
distinct, so no cache keyed on file content can serve one file for
another. The pool's block densities and every file's share of each pool
block are the same for every seed (`pool_blocks`, `draw_ids`): a seed
changes the coefficients and the order, not the work.

The join works on bytes, not bits: each pool block is packed once for
each of the 8 bit phases it can start at, as a head byte (the bits that
share a byte with the block before) and a body. A file is the header and
the bodies concatenated, with the heads OR-ed into the bytes they share.

Hostile files are clean compositions of their class with bits flipped
(bytes after the 14-byte header) or the tail cut off, as bench.py's
corrupt members are; each records the first bit that differs from its
composition, for the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import encoder

ACM_HEADER_BITS = 112


@dataclasses.dataclass
class ClassSpec:
    """One class of a configuration's files (a JSON object of its
    `classes` list)."""

    tag: str
    files: int
    level: int
    rows: int
    #: blocks of every file, or [lo, hi]: the class's lengths spread evenly
    #: from lo to hi (the same set for every seed, in a seeded order)
    blocks: int | list
    channels: int
    rate: int
    wavc: bool
    base_pwr: int
    decay_cols: float

    @property
    def block_len(self) -> int:
        return self.rows << self.level

    def lengths(self) -> np.ndarray:
        if isinstance(self.blocks, int):
            return np.full(self.files, self.blocks, dtype=np.int64)
        lo, hi = self.blocks
        return np.rint(np.linspace(lo, hi, self.files)).astype(np.int64)


@dataclasses.dataclass
class Pool:
    """A class's encoded blocks: `data` is a whole ACM stream of them, and
    block b is bits [offsets[b], offsets[b + 1]) of it."""

    spec: ClassSpec
    data: bytes
    offsets: np.ndarray
    _body: list
    _head: np.ndarray

    @property
    def n_blocks(self) -> int:
        return len(self.offsets) - 1

    @property
    def nbits(self) -> np.ndarray:
        return np.diff(self.offsets)


def _header(spec: ClassSpec, n_blocks: int) -> bytes:
    w = encoder.BitWriter()
    encoder.write_header(w, n_blocks * spec.block_len, spec.channels,
                         spec.rate, spec.level, spec.rows)
    return w.getvalue()


def pool_blocks(rng: np.random.Generator, spec: ClassSpec,
                n_blocks: int) -> list:
    """n_blocks audio-like blocks of the class, as the port's fixture
    encoder makes them (speech_blocks: Laplacian coefficients under an
    exponential spectral envelope, energy falling with frequency; a
    block's power base_pwr - 2 .. base_pwr + 2, its envelope width
    decay_cols times 0.5 .. 1.5, its step 100 .. 1999), but with those
    three drawn as evenly spread values in a seeded order, so that every
    seed's pool holds blocks of the same densities and only the
    coefficients and the order change."""
    cols = 1 << spec.level
    c_idx = np.arange(cols)
    spread = (np.arange(n_blocks) + 0.5) / n_blocks
    pwrs = np.clip(spec.base_pwr + rng.permutation(np.arange(n_blocks) % 5)
                   - 2, 1, 15)
    taus = spec.decay_cols * (0.5 + rng.permutation(spread))
    vals = (100 + rng.permutation(spread) * 1900).astype(int)
    out = []
    for pwr, tau, val in zip(pwrs.tolist(), taus.tolist(), vals.tolist()):
        count = 1 << pwr
        env = count * np.exp(-c_idx / max(tau, 1e-6))
        k = rng.laplace(0.0, np.maximum(env[None, :] / 3.0, 1e-9),
                        size=(spec.rows, cols))
        k = np.clip(np.round(k), -count, count - 1).astype(np.int32)
        k[:, env < 1.0] = 0  # subthreshold bands are silent
        out.append(encoder.BlockData(pwr=pwr, val=val, k=k))
    return out


def make_pool(rng: np.random.Generator, spec: ClassSpec,
              n_blocks: int) -> Pool:
    """Encode the class's pool blocks (pool_blocks; the cheapest filler
    per column, as real encoders choose) and pack each for every bit
    phase."""
    blocks = pool_blocks(rng, spec, n_blocks)
    w = encoder.BitWriter()
    encoder.write_header(w, n_blocks * spec.block_len, spec.channels,
                         spec.rate, spec.level, spec.rows)
    offsets = []
    for b in blocks:
        offsets.append(w.bitpos)
        w.put(b.pwr, 4)
        w.put(b.val, 16)
        for c in range(b.k.shape[1]):
            ks = b.k[:, c]
            encoder.encode_column(w, ks, encoder.choose_filler_best(ks))
    offsets.append(w.bitpos)
    data = w.getvalue()
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    body = []
    head = np.zeros((n_blocks, 8), dtype=np.uint8)
    for b in range(n_blocks):
        blk = bits[offsets[b]:offsets[b + 1]]
        phases = []
        for f in range(8):
            packed = np.packbits(np.concatenate(
                [np.zeros(f, np.uint8), blk]), bitorder="little")
            if f:
                head[b, f] = packed[0]
                packed = packed[1:]
            phases.append(packed)
        body.append(phases)
    return Pool(spec, data, np.asarray(offsets, np.int64), body, head)


def compose(pool: Pool, ids: np.ndarray) -> bytes:
    """The stream of pool blocks `ids`, in order, behind a header that
    counts them (and the WAVC wrapper where the class has one)."""
    hdr = np.frombuffer(_header(pool.spec, len(ids)), np.uint8)
    starts = ACM_HEADER_BITS + np.concatenate(
        [[0], np.cumsum(pool.nbits[ids])[:-1]]).astype(np.int64)
    phase = starts % 8
    out = np.concatenate([hdr] + [pool._body[b][f] for b, f in
                                  zip(ids.tolist(), phase.tolist())])
    shared = phase != 0
    out[starts[shared] // 8] |= pool._head[ids[shared], phase[shared]]
    data = out.tobytes()
    return encoder.wavc_wrap(data) if pool.spec.wavc else data


@dataclasses.dataclass
class BenchFile:
    """One file: its class, its pool blocks, its bytes, and the first bit
    (of `data`) that differs from that composition (None: no bit does)."""

    cls: int
    ids: np.ndarray
    data: bytes
    first_changed_bit: int | None = None
    kind: str = "clean"


@dataclasses.dataclass
class Corpus:
    classes: list[ClassSpec]
    pools: list[Pool]
    files: list[BenchFile]

    @property
    def n_bytes(self) -> int:
        return sum(len(f.data) for f in self.files)


def draw_ids(rng: np.random.Generator, pool_blocks: int,
             n: int) -> np.ndarray:
    """n pool block ids: seeded permutations of the whole pool, one after
    another, so every file holds the pool's blocks in near-equal shares
    (the same density of bits) in its own order."""
    reps = -(-n // pool_blocks)
    return np.concatenate([rng.permutation(pool_blocks)
                           for _ in range(reps)])[:n]


def class_specs(config: dict) -> list[ClassSpec]:
    return [ClassSpec(**c) for c in config["classes"]]


def make_corpus(config: dict, seed: int) -> Corpus:
    """The configuration's files from `seed`: every class's files (each
    length in a seeded order), then the hostile files, made from clean
    compositions of their class. The same seed gives the same bytes."""
    classes = class_specs(config)
    ss = np.random.SeedSequence(seed)
    pool_ss, draw_ss, hostile_ss = ss.spawn(3)
    pool_rngs = [np.random.default_rng(s)
                 for s in pool_ss.spawn(len(classes))]
    pools = [make_pool(r, c, config["pool_blocks"])
             for r, c in zip(pool_rngs, classes)]
    draw = np.random.default_rng(draw_ss)
    files = []
    for ci, (spec, pool) in enumerate(zip(classes, pools)):
        for nb in draw.permutation(spec.lengths()):
            ids = draw_ids(draw, pool.n_blocks, int(nb))
            files.append(BenchFile(ci, ids, compose(pool, ids)))
    hostile = config.get("hostile")
    if hostile:
        rng = np.random.default_rng(hostile_ss)
        ci = [c.tag for c in classes].index(hostile["class"])
        spec, pool = classes[ci], pools[ci]
        for i in range(hostile["files"]):
            ids = draw_ids(rng, pool.n_blocks, int(spec.lengths()[0]))
            data = compose(pool, ids)
            if i % 5 < hostile["flipped_of_5"]:
                b = bytearray(data)
                pos = rng.integers(14, len(b), hostile["flips"])
                bit = rng.integers(0, 8, hostile["flips"])
                for p, q in zip(pos.tolist(), bit.tolist()):
                    b[p] ^= 1 << q
                files.append(BenchFile(ci, ids, bytes(b),
                                       int((8 * pos + bit).min()),
                                       "flipped"))
            else:
                n = int(len(data) * hostile["keep_fraction"])
                files.append(BenchFile(ci, ids, data[:n], 8 * n,
                                       "truncated"))
    return Corpus(classes, pools, files)
