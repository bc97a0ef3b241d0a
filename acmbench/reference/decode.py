"""The plain reference decode of the benchmark's files: what a decoder that
follows the C reference (markokr/libacm) must hand back for each file.

Imports numpy, torch and the benchmark's frozen copies only, never the
program under test, and takes nothing the program made.

Scan. Every file the benchmark makes is a header and blocks cut from a
class's pool (acmbench.gen.pool), joined bit by bit. A block's coefficient
indices depend on its bits alone, so each pool is scanned once by the
oracle (`oracle.scan_bytes`) and a clean file's blocks are its pool
blocks in order. A hostile file (bits flipped, or cut short) is its pool
blocks up to the first block a changed bit touches, then the oracle's
scanner resumed there on the file's own bytes (`BitReader.at_bit`, with
the amplitude table the blocks before left) to the end: the same events,
blocks and stale-table reads as a scan from bit 0 (held by
acmbench/tests/test_acmbench_reference.py).

Synthesis. Each filterbank pass is an order-2 FIR down the rows of the
pass's [rows << (p+1), cols >> (p+1)] view of a block, carried over block
boundaries by the last two rows (oracle.synth_block). Those views of
consecutive blocks are consecutive rows of one view of the whole file, so
a pass over a file is one FIR over that view, from a zero carry. Batched
over the files of a class, in int64 with every sum wrapped to int32 as
the C does, on whatever device it is given (the card, after the window,
or the CPU). `dtype=torch.float32` computes the same passes in float32:
the benchmark's control.

Output. For each file: the PCM of every good block (what
DeviceCorpus.device_arrays leaves on the card and checksum() sums, k*val
dequantized), the events, the status, the words `acmtool -d` writes and the
filler it adds (the C CLI's read loop, `stops`), and, for a file with
stale-table reads, its exact PCM apart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import oracle
from .format import ACM_EXPECTED_EOF, AcmHeader, cli_total_bytes
from .stops import cli_stop_words, effective_stop

#: files synthesized together at most (the int64 work is 8 bytes a sample)
SYNTH_FILES = 64


@dataclasses.dataclass
class PoolScan:
    """The oracle's scan of one class's pool stream."""

    header: AcmHeader
    #: int16 [P, rows * cols]
    k: np.ndarray
    pwr: np.ndarray
    val: np.ndarray
    #: int64 [P]: each block's length in bits
    nbits: np.ndarray


def scan_pool(pool_data: bytes, n_blocks: int) -> PoolScan:
    """Scan a pool stream with the oracle, one block at a time, and take
    each block's length in bits from the reader; every block has to
    decode, inside its amplitude table."""
    bits = oracle.BitReader(pool_data)
    h = oracle.parse_header(bits)
    if h is None:
        raise ValueError("pool stream has no ACM header")
    k, pwr, val, nbits = [], [], [], []
    for _ in range(n_blocks):
        before = bits.consumed_bits
        s = oracle.scan_blocks(bits, h, max_blocks=1)
        if s.n_blocks != 1 or np.any(s.events != 0) or s.n_exceptions:
            raise ValueError("pool stream did not scan clean")
        k.append(s.k.reshape(h.block_len))
        pwr.append(s.pwr[0])
        val.append(s.val[0])
        nbits.append(bits.consumed_bits - before)
    return PoolScan(h, np.stack(k), np.asarray(pwr, np.uint8),
                    np.asarray(val, np.uint16), np.asarray(nbits, np.int64))


@dataclasses.dataclass
class FileScan:
    """A file's scan: its good blocks as pool block ids (clean files) or as
    coefficient arrays (hostile files), with the oracle's events."""

    header: AcmHeader
    channels: int
    #: pool block ids of the good blocks (clean file), else None
    ids: np.ndarray | None
    #: int16 [n_good, block_len] and uint16 [n_good] (hostile file)
    k: np.ndarray | None
    val: np.ndarray | None
    events: np.ndarray
    exc_block: np.ndarray
    exc_flat: np.ndarray
    exc_val: np.ndarray

    @property
    def n_good(self) -> int:
        return int(np.count_nonzero(self.events == 0))


def file_header(data: bytes) -> AcmHeader:
    h = oracle.parse_header(oracle.BitReader(data))
    if h is None:
        raise ValueError("not an ACM stream")
    return h


def scan_file(data: bytes, header: AcmHeader, channels: int,
              ids: np.ndarray | None = None, pool: PoolScan | None = None,
              first_changed_bit: int | None = 0) -> FileScan:
    """A file of pool blocks `ids`, whose bits from `first_changed_bit` on
    may differ from that composition (None: none do). Without ids and a
    pool: any stream, scanned whole."""
    none = np.zeros(0, np.int32)
    if first_changed_bit is None:
        return FileScan(header, channels, np.asarray(ids), None, None,
                        np.zeros(len(ids), np.int16), none, none, none)
    start = 8 * (28 if header.wavc_file else 0) + 112  # header bits
    j0, bit0 = 0, start
    if pool is not None:
        ends = start + np.cumsum(pool.nbits[ids])
        j0 = int(np.searchsorted(ends, first_changed_bit, side="right"))
        bit0 = int(ends[j0 - 1]) if j0 else start
    last_val = np.zeros(17, dtype=np.int64)
    covered = np.zeros(17, dtype=bool)
    for b in (ids[:j0] if j0 else []):
        last_val[: int(pool.pwr[b]) + 1] = int(pool.val[b])
        covered[: int(pool.pwr[b]) + 1] = True
    tail = oracle.scan_blocks(oracle.BitReader.at_bit(data, bit0), header,
                              max_blocks=header.n_blocks - j0,
                              init_table=(last_val, covered))
    tail_k = tail.k.reshape(tail.n_blocks, header.block_len)
    if not j0:
        return FileScan(header, channels, None, tail_k,
                        tail.val.astype(np.uint16), tail.events,
                        tail.exc_block, tail.exc_flat, tail.exc_val)
    k = np.concatenate([pool.k[ids[:j0]], tail_k])
    val = np.concatenate([pool.val[ids[:j0]], tail.val]).astype(np.uint16)
    events = np.concatenate([np.zeros(j0, np.int16), tail.events])
    return FileScan(header, channels, None, k, val, events,
                    tail.exc_block + j0, tail.exc_flat, tail.exc_val)


def first_error(events: np.ndarray) -> int:
    bad = events[events != 0]
    return int(bad[0]) if len(bad) else 0


def cli_result(fs: FileScan) -> tuple[int, int, int]:
    """(status, words `acmtool -d` writes, filler words it adds) of a
    scanned file: the C CLI's read loop over the scan's events."""
    h, ch = fs.header, fs.channels
    err = first_error(fs.events)
    status = err if err not in (0, ACM_EXPECTED_EOF) else 0
    if cli_total_bytes(h.total_values, ch) <= 0:
        return status, 0, 0
    if err != 0:
        stop = cli_stop_words(fs.events, h.block_len, h.total_values, ch)
    else:
        stop = effective_stop(h.total_values, h.block_len, ch,
                              fs.n_good * h.block_len)
    want = h.total_values - (h.total_values % ch if ch > 1 else 0)
    return status, stop, max(0, want - stop)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def synth(x: torch.Tensor, level: int, rows: int,
          dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """int16 PCM [B, n] of dequantized words x [B, n] (n a whole number of
    blocks), every file from a zero carry: the oracle's passes over the
    whole file at once. int64 with int32 wrap-around is exact; float32 is
    the control."""
    B, n = x.shape
    cols = 1 << level
    y = x.to(dtype)
    for p in range(level):
        sub_len = cols >> (p + 1)
        m = y.reshape(B, -1, sub_len)
        s = torch.cat([torch.zeros(B, 2, sub_len, dtype=dtype,
                                   device=x.device), m], dim=1)
        a, b, c = s[:, 2:], s[:, 1:-1], s[:, :-2]
        sgn = torch.ones(m.shape[1], 1, dtype=dtype, device=x.device)
        sgn[1::2] = -1
        out = sgn * (a + c) + 2 * b
        if p == 0:
            out[:, :, 0] += 1
        y = (_wrap32(out) if dtype == torch.int64 else out).reshape(B, n)
    w = y.to(torch.int64) if dtype != torch.int64 else y
    w = _wrap32(w) >> level
    return (((w + (1 << 15)) & 0xFFFF) - (1 << 15)).to(torch.int16)


@dataclasses.dataclass
class Expected:
    """The reference's answer for one file."""

    #: int16 PCM of every good block, k*val dequantized, on the device
    pcm: torch.Tensor
    n_good: int
    status: int
    #: words acmtool -d writes, and the filler words it adds
    stop: int
    filler: int
    #: int16 exact PCM (stale-table reads applied) for a file that has
    #: them, else None (then `pcm` is exact)
    exact: torch.Tensor | None
    block_len: int
    channels: int
    total_values: int

    def exact_pcm(self) -> torch.Tensor:
        return self.pcm if self.exact is None else self.exact


def _dequantize(k: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return _wrap32(k.to(torch.int64) * val.to(torch.int64)[..., None])


def expected_files(scans: list[FileScan], pools: dict[int, PoolScan],
                   classes: list[int], device,
                   dtype: torch.dtype = torch.int64) -> list[Expected]:
    """The reference's answer for every file (scans[i] of class
    classes[i]), PCM on `device`; files of one class and length are
    synthesized together, SYNTH_FILES at a time."""
    dev = torch.device(device)
    pool_dev = {c: (torch.from_numpy(p.k).to(dev),
                    torch.from_numpy(p.val.astype(np.int32)).to(dev))
                for c, p in pools.items()}
    groups: dict[tuple, list[int]] = {}
    for i, fs in enumerate(scans):
        clean = fs.ids is not None
        groups.setdefault((classes[i], clean, fs.n_good if clean else i),
                          []).append(i)
    out: list[Expected | None] = [None] * len(scans)
    for (c, clean, _), members in groups.items():
        h = scans[members[0]].header
        for lo in range(0, len(members), SYNTH_FILES):
            part = members[lo : lo + SYNTH_FILES]
            if clean:
                ids = torch.from_numpy(
                    np.stack([scans[i].ids for i in part])).to(dev).long()
                pk, pv = pool_dev[c]
                x = _dequantize(pk[ids], pv[ids])
            else:
                fs = scans[part[0]]
                x = _dequantize(torch.from_numpy(fs.k).to(dev),
                                torch.from_numpy(
                                    fs.val.astype(np.int32)).to(dev))[None]
            pcm = synth(x.reshape(len(part), -1), h.level, h.rows, dtype)
            for j, i in enumerate(part):
                fs = scans[i]
                exact = None
                if len(fs.exc_block):
                    xe = x[j].reshape(-1).clone()
                    flat = fs.exc_block.astype(np.int64) * h.block_len \
                        + fs.exc_flat
                    xe[torch.from_numpy(flat).to(dev)] = torch.from_numpy(
                        fs.exc_val.astype(np.int64)).to(dev)
                    exact = synth(xe[None], h.level, h.rows, dtype)[0]
                status, stop, filler = cli_result(fs)
                out[i] = Expected(pcm[j], fs.n_good, status, stop, filler,
                                  exact, h.block_len, fs.channels,
                                  h.total_values)
    return out  # type: ignore[return-value]
