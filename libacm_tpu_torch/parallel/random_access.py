"""O(segment) random access into ACM streams (BASELINE config 5).

The reference's seek is reset + decode-forward: O(target) every time
(util.c:214-253), because the bitstream has no block framing. Here a
one-time scan builds a **BlockIndex** (each block's absolute starting bit
offset — the reader state at any consumed-bit count is reconstructible in
O(1), see BitReader::seek_to_bit in _scan.cpp); afterwards any segment
decodes in O(segment):

  1. scan blocks [a-1, b) starting at index[a-1] (one warm-up block);
  2. synthesize them with a zero carry and drop block a-1's output —
     exact because, for rows >= 2, an unknown carry pollutes only each
     pass's head region while the outgoing carries come from pass-input
     tails (ops.synth_torch.carry_of_block discussion);
  3. slice/clamp to the requested words.

rows == 1 streams fall back to decoding the prefix [0, b).

The port of libacm_tpu/parallel/random_access.py. Step 2 runs on the
card by default — the corpus path's cols-wire unpack and the CUDA
synthesis kernel, one file per launch — and backend="host" takes the
fused native host decoder (the JAX package's default route).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..format import AcmHeader
from ..scan import native
from ..scan.oracle import BitReader, parse_header
from .corpus import _round_up


@dataclasses.dataclass
class BlockIndex:
    """Random-access index of one stream (8 bytes per block)."""

    header: AcmHeader
    #: int64 [n_good]: absolute bit offset where block i begins.
    bitpos: np.ndarray
    n_good: int
    first_err: int
    #: stream has out-of-range coefficients (stale-amp-table semantics);
    #: segment reads fall back to an exact full host decode
    oor: bool = False

    @property
    def words_avail(self) -> int:
        return self.n_good * self.header.block_len

    #: serialization magic: "ABIX" + format version
    _MAGIC = b"ABIX\x01"

    def to_bytes(self) -> bytes:
        """Serialize (~8 bytes/block): persist next to the stream so a
        serving process seeks immediately instead of re-scanning O(file)
        at first touch (the index is the expensive half of random
        access; the reference rebuilds its position state on every
        backward seek, util.c:214-253)."""
        import struct

        h = self.header
        head = struct.pack(
            "<5sqiiHHBBqqB", self._MAGIC, h.total_values, h.channels,
            h.rate, h.level, h.rows, int(h.wavc_file), int(self.oor),
            self.n_good, self.first_err, 0)
        return head + np.ascontiguousarray(
            self.bitpos, dtype="<i8").tobytes()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "BlockIndex":
        import struct

        fmt = "<5sqiiHHBBqqB"
        n = struct.calcsize(fmt)
        if len(blob) < n or not blob.startswith(cls._MAGIC):
            raise ValueError("not a serialized BlockIndex")
        (_m, total_values, channels, rate, level, rows, wavc, oor,
         n_good, first_err, _rsv) = struct.unpack(fmt, blob[:n])
        bitpos = np.frombuffer(blob, dtype="<i8", offset=n).astype(np.int64)
        if len(bitpos) != n_good:
            raise ValueError("truncated BlockIndex payload")
        return cls(
            header=AcmHeader(total_values=total_values, channels=channels,
                             rate=rate, level=level, rows=rows,
                             wavc_file=bool(wavc)),
            bitpos=bitpos, n_good=n_good, first_err=first_err,
            oor=bool(oor))


_TLS = threading.local()


def _bufs(nbytes: int) -> native.CorpusScanBuffers:
    bufs = getattr(_TLS, "bufs", None)
    if bufs is None or not bufs.fits(nbytes):
        bufs = native.CorpusScanBuffers(max_file_bytes=max(1 << 22, nbytes))
        _TLS.bufs = bufs
    return bufs


def _scan_span(data: bytes, header: AcmHeader, start_bit: int | None,
               max_blocks: int, bitpos_out: np.ndarray | None = None,
               pooled: bool = False, device: torch.device | None = None):
    """Scan up to max_blocks from start_bit into wire buffers.

    pooled=True routes through the corpus layer's reusable wire-buffer
    pool for `device` (the serving path: read_segment calls at a fixed
    bucketed shape must not page-fault fresh multi-MB buffers per
    request; a CPU target is never pooled); the caller must have copied
    the arrays to the device before the next pooled call on this thread.
    """
    rows, cols = header.rows, header.cols
    if pooled:
        from .corpus import _acquire_wire_bufs

        w = _acquire_wire_bufs(1, max_blocks, header.level, rows, device)
        cls, pwr, vals = w.cls, w.pwr, w.vals
        pay = (w.pay4, w.pay8, w.pay16)
        wid = (w.wid4, w.wid8, w.wid16)
    else:
        ncols_cap = max_blocks * cols
        c4, c8, c16, cw = native.pay_stream_caps(ncols_cap, rows)
        cls = np.zeros((1, max_blocks, (cols + 3) // 4), dtype=np.uint8)
        pwr = np.zeros((1, max_blocks), dtype=np.uint8)
        vals = np.zeros((1, max_blocks), dtype=np.uint16)
        pay = tuple(np.zeros(c, dtype=np.uint8) for c in (c4, c8, c16))
        wid = tuple(np.zeros(cw, dtype=np.uint8) for _ in range(3))
    ng, err, ncol, bits, oor, _events = native.scan_corpus_into(
        data, header, cls[0], pwr[0], vals[0], *pay, *wid,
        _bufs(len(data)), start_bit=start_bit, bitpos_out=bitpos_out,
    )
    return ng, err, cls, vals, pay, wid, ncol, bits, oor


def build_index(data: bytes) -> BlockIndex:
    """One full scan → BlockIndex (also reports the stream's good-block
    count and first error, like corpus decode)."""
    header = parse_header(BitReader(data))
    if header is None:
        raise ValueError("not an ACM stream")
    cap = header.max_blocks_in(len(data))
    bitpos = np.zeros(cap, dtype=np.int64)
    out = _scan_span(data, header, None, cap, bitpos)
    ng, err, oor = out[0], out[1], out[-1]
    del out  # release the wire arrays before the bitpos copy
    return BlockIndex(header=header, bitpos=bitpos[:ng].copy(), n_good=ng,
                      first_err=err, oor=oor)


class RandomAccessCorpus:
    """Random access over a corpus of files (indexes built lazily, cached).

    The corpus-scale counterpart of acm_seek_pcm (BASELINE config 5):
    `read(i, start_pcm, n_pcm)` returns per-channel-frame PCM from file i
    in O(segment), after a one-time index scan of that file.

    Memory policy: file BYTES are held in an LRU capped at
    `max_cached_files` (a 10k-file random-access sweep must not
    accumulate the whole corpus in RSS — bytes re-read from the source
    on a miss), while the small BlockIndexes (8 bytes/block) are kept in
    a much larger LRU (`max_cached_indexes`) so an evicted file's next
    read skips the O(file) index rescan.
    """

    def __init__(self, sources, force_chans: int = 0,
                 max_cached_files: int = 8,
                 max_cached_indexes: int = 65536,
                 backend: str | None = None, index_dir=None, device=None):
        from .corpus import _read_source  # shared byte loader

        self._sources = list(sources)
        self._read_source = _read_source
        self._force_chans = force_chans
        _check_backend(backend)
        self._backend = backend
        #: segments synthesize here (None: the card, resolved now so that
        #: a corpus without one fails at construction); unused by "host"
        self._device = None if backend == "host" else resolve_device(device)
        self._max_files = max(1, max_cached_files)
        self._max_indexes = max(1, max_cached_indexes)
        self._data_lru: "dict[int, bytes]" = {}
        self._index_lru: "dict[int, tuple[BlockIndex, int]]" = {}
        #: serving is typically multi-threaded; the LRUs mutate on every
        #: read, so cache admission/eviction runs under one lock (the
        #: segment decode itself is outside it — scans are GIL-free and
        #: per-thread via the wire-buffer TLS)
        self._lock = threading.Lock()
        #: optional on-disk index store (BlockIndex.to_bytes blobs keyed
        #: by content hash): a serving fleet pays each file's O(file)
        #: index scan once ever, not once per process
        self._index_dir = None
        if index_dir is not None:
            import pathlib

            self._index_dir = pathlib.Path(index_dir)
            self._index_dir.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _touch(lru: dict, key, cap: int, value):
        """Insert/refresh under the caller's lock; evict past cap."""
        lru.pop(key, None)
        while len(lru) >= cap:
            lru.pop(next(iter(lru)))  # evict least recently used
        lru[key] = value
        return value

    def _entry(self, i: int):
        # The lock covers only LRU lookup/admission; the expensive work
        # (file IO, the O(file) index scan — both GIL-releasing) runs
        # OUTSIDE it so cold first-touches from many serving threads
        # proceed in parallel. A racing miss may build the same entry
        # twice; the duplicates are identical and the loser is dropped
        # by admission — cheaper than serializing every cold read.
        with self._lock:
            data = self._data_lru.pop(i, None)
            if data is not None:
                self._data_lru[i] = data  # refresh recency
            hit = self._index_lru.pop(i, None)
            if hit is not None:
                self._index_lru[i] = hit
                if data is not None:  # both warm: done (serving steady state)
                    return data, hit[0], hit[1]
        if data is None:
            data = self._read_source(self._sources[i])
        if hit is None:
            hit = self._make_index(data)
        with self._lock:
            self._touch(self._data_lru, i, self._max_files, data)
            idx, ch = self._touch(self._index_lru, i, self._max_indexes,
                                  hit)
        return data, idx, ch

    def _make_index(self, data: bytes):
        from ..format import resolve_channels

        idx = path = None
        if self._index_dir is not None:
            import hashlib

            path = self._index_dir / (
                hashlib.sha1(data).hexdigest() + ".abix")
            try:
                idx = BlockIndex.from_bytes(path.read_bytes())
            except (OSError, ValueError):
                idx = None  # absent or corrupt: rebuild below
        if idx is None:
            idx = build_index(data)
            if path is not None:
                try:
                    path.write_bytes(idx.to_bytes())
                except OSError:
                    pass  # store is best-effort, never load-bearing
        ch = resolve_channels(idx.header.channels, idx.header.wavc_file,
                              self._force_chans)
        return idx, ch

    def pcm_total(self, i: int) -> int:
        data, idx, ch = self._entry(i)
        return idx.header.total_values // ch

    def read(self, i: int, start_pcm: int, n_pcm: int) -> np.ndarray:
        """int16 [n, channels] frames from file i (clamped at stream end)."""
        data, idx, ch = self._entry(i)
        words = read_segment(data, idx, start_pcm * ch, n_pcm * ch,
                             backend=self._backend, device=self._device)
        return words[: len(words) - len(words) % ch].reshape(-1, ch)

    @property
    def cached_files(self) -> int:
        return len(self._data_lru)


def _check_backend(backend) -> None:
    if backend not in (None, "host"):
        raise ValueError(f"unknown backend {backend!r} (None decodes on the "
                         "device, 'host' with the native host decoder)")


def _stale(nb: int, n_good: int) -> ValueError:
    # externally reachable (never an internal invariant): the index said
    # these blocks decode, so the BYTES must have changed since it was
    # built (file rewritten under a cached or persisted index) — raising
    # beats serving garbage PCM
    return ValueError(
        f"index/stream mismatch: indexed span of {nb} blocks decodes only "
        f"{n_good} — stale BlockIndex for these bytes (rebuild with "
        "build_index)")


def read_segment(data: bytes, index: BlockIndex, start_word: int,
                 n_words: int, backend: str | None = None,
                 device=None) -> np.ndarray:
    """Decode int16 words [start_word, start_word + n_words) in O(segment).

    Clamps to the decodable stream end (min(total_values, words_avail));
    returns possibly fewer words at the tail, empty beyond it.

    backend=None (the default) synthesizes the span on `device` (None: the
    card, or $LIBACM_TPU_TORCH_DEVICE; raises without one): the span's
    cols-wire, copied in one blob, unpacked and synthesized by the corpus
    path's kernel wrapper (the CUDA kernel on a card, its plain version on
    the CPU), then fetched. backend="host" decodes the span with the fused
    native host decoder (one C++ sweep; the JAX package's default route).
    Both routes raise ValueError for an index that no longer fits the
    bytes.
    """
    _check_backend(backend)
    dev = None if backend == "host" else resolve_device(device)
    h = index.header
    bl = h.block_len
    end_avail = min(h.total_values, index.words_avail)
    start_word = max(0, start_word)
    stop_word = min(start_word + max(0, n_words), end_avail)
    if stop_word <= start_word:
        return np.zeros(0, dtype=np.int16)

    if index.oor:
        # stale-amp-table stream: only a full host decode is exact
        from ..scan import oracle as _oracle

        _, pcm, _ = _oracle.decode_bytes(data)
        return pcm[start_word:stop_word].copy()

    a = start_word // bl
    b = -(-stop_word // bl)
    warm = 1 if (a > 0 and h.rows >= 2) else a  # rows==1: prefix fallback
    a0 = a - warm
    nb = b - a0
    lo = start_word - a0 * bl
    start_bit = int(index.bitpos[a0]) if a0 > 0 else None

    if backend == "host":
        hd = native.decode_host(data, header=h, max_blocks=nb,
                                start_bit=start_bit)
        if hd.n_good != nb:
            raise _stale(nb, hd.n_good)
        # copy: hd.pcm is a view of a refcount-gated pooled buffer
        return hd.pcm[lo : lo + (stop_word - start_word)].copy()

    nbp = _round_up(nb, 8)
    ng, err, cls, vals, pay, wid, ncol, bits, _oorseg = _scan_span(
        data, h, start_bit, nbp, pooled=True, device=dev)
    if ng < nb:
        raise _stale(nb, ng)

    from ..ops.synth_torch import synth_pcm_cols_blob
    from .corpus import _coalesce_wire

    def _sl(arr, used_bytes):
        n = min(_round_up(used_bytes + 2, 256), len(arr))
        return arr[: n - (n & 1)]

    # the pooled arrays are read only by this memcpy into a fresh blob;
    # the blob's copy to the device and the synchronous .cpu() below both
    # finish before return, so the buffer set is free for the next call
    blob, lens = _coalesce_wire((
        cls,
        _sl(pay[0], -(-bits[0] // 8)),
        _sl(pay[1], -(-bits[1] // 8)),
        _sl(pay[2], -(-bits[2] // 8)),
        _sl(wid[0], -(-ncol[0] // 2)),
        _sl(wid[1], -(-ncol[1] // 2)),
        _sl(wid[2], -(-ncol[2] // 2)),
        vals,
        np.zeros((1, h.wrapbuf_len), np.int32),
    ))
    pcm, _ = synth_pcm_cols_blob(
        torch.from_numpy(blob).to(dev), level=h.level, rows=h.rows, batch=1,
        nb=nbp, backend="cuda", lens=lens,
    )
    flat = pcm[0].cpu().numpy().reshape(-1)
    return flat[lo : lo + (stop_word - start_word)]
