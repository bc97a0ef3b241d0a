"""O(segment) random access into ACM streams (BASELINE config 5).

The reference's seek is reset + decode-forward: O(target) every time
(util.c:214-253), because the bitstream has no block framing. Here a
one-time scan builds a **BlockIndex** (each block's absolute starting bit
offset — the reader state at any consumed-bit count is reconstructible in
O(1), see BitReader::seek_to_bit in _scan.cpp); afterwards any segment
decodes in O(segment): its blocks are scanned from a warm-up block's
indexed bit and synthesized with a zero carry, and the warm-up block's
output is dropped — exact because, for rows >= 2, an unknown carry
pollutes only each pass's head region while the outgoing carries come
from pass-input tails (ops.synth_torch.carry_of_block discussion);
rows == 1 streams warm up over the whole prefix. Every read, on either
route, is a batch of crops planned by one native call, acm_scan_crops
in scan/_crops.cpp (native.scan_crops): which words of a crop exist,
and which blocks it synthesizes. That plan lives there alone.

The port of libacm_tpu/parallel/random_access.py. The synthesis runs on
the card by default — the corpus path's cols-wire unpack and the CUDA
synthesis kernel — and backend="host" takes the fused native host
decoder (the JAX package's default route). A segment's device read is
the batch read below with one crop, fetched to the host.

`RandomAccessCorpus.read_batch(files, starts, frames)` is the training
loader's read: B crops of B files at once, left on the card as int16
[B, frames, channels]. One GIL-free native call plans the B crops, scans
their spans in place in their clips' bytes and lays the batch's wire and
metadata out in one pinned blob, which crosses without waiting; each
geometry of the batch takes one unpack and one synthesis launch over
[B, nb] blocks; a gather on the card cuts each crop out of its row and
zero-pads it past its clip's decodable end (HiFi-GAN's rule for a clip
shorter than a crop).
The PCM stays on the card because a training step reads it there: a
fetch to the host and a copy back would cost two copies and a
synchronisation a batch. Nothing in it synchronises, so the caller's
next batch is scanned while the card works on this one.
"""

from __future__ import annotations

import dataclasses
import struct
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..format import AcmHeader
from ..scan import native
from ..scan.oracle import BitReader, parse_header
from ..utils import profiling


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


def _index_scratch(max_blocks: int, level: int, rows: int) -> tuple:
    """This thread's wire arrays for index scans of a geometry, grown to
    max_blocks: an index scan keeps only the block offsets, and the
    scanner never reads back what it has not written in this scan (as
    native.scan_bytes_packed reuses its scratch), so no file pays a fresh
    zeroed allocation and its page faults."""
    pool = getattr(_TLS, "index_scratch", None)
    if pool is None:
        pool = _TLS.index_scratch = {}
    have = pool.get((level, rows))
    if have is None or have[0].shape[0] < max_blocks:
        cap = 1 << max(6, (max_blocks - 1).bit_length())
        cols = 1 << level
        c4, c8, c16, cw = native.pay_stream_caps(cap * cols, rows)
        have = pool[(level, rows)] = (
            np.zeros((cap, (cols + 3) // 4), np.uint8),
            np.zeros(cap, np.uint8), np.zeros(cap, np.uint16),
            *(np.zeros(c, np.uint8) for c in (c4, c8, c16, cw, cw, cw)))
    return have


def build_index(data: bytes) -> BlockIndex:
    """One full scan → BlockIndex (also reports the stream's good-block
    count and first error, like corpus decode)."""
    header = parse_header(BitReader(data))
    if header is None:
        raise ValueError("not an ACM stream")
    cap = header.max_blocks_in(len(data))
    bitpos = np.zeros(cap, dtype=np.int64)
    ng, err, _, _, oor, _ = native.scan_corpus_into(
        data, header, *_index_scratch(cap, header.level, header.rows),
        native.scan_buffers(len(data)), bitpos_out=bitpos, max_blocks=cap)
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
    read skips the O(file) index rescan. A training loader that draws
    crops from every clip of an epoch (`read_batch`) should set
    `max_cached_files` to its whole training set: a smaller LRU re-reads
    nearly every file of a shuffled epoch from its source.
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
        #: each cached file's entry (bytes, index, channels, its row of
        #: the native crop table, what the row points into), registered
        #: once and dropped with the file's bytes
        self._clip_rows: "dict[int, tuple]" = {}
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
    def _touch(lru: dict, key, cap: int, value) -> list:
        """Insert/refresh under the caller's lock; evict past cap, and
        return the keys evicted."""
        lru.pop(key, None)
        gone = []
        while len(lru) >= cap:
            gone.append(next(iter(lru)))  # evict least recently used
            del lru[gone[-1]]
        lru[key] = value
        return gone

    def _register(self, i: int, data, hit: tuple) -> tuple:
        """File i's entry, under the caller's lock: registered anew in
        the native crop table only where its bytes or its index changed."""
        reg = self._clip_rows.get(i)
        if reg is None or reg[0] is not data or reg[1] is not hit[0]:
            idx, ch = hit
            row, keep = native.clip_row(data, idx.bitpos, idx.header,
                                        idx.n_good, ch, idx.oor)
            reg = self._clip_rows[i] = (data, idx, ch, row, keep)
        return reg

    def _entry(self, i: int) -> tuple:
        """(bytes, BlockIndex, channels, native crop table row, what the
        row points into) of file i."""
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
                    return self._register(i, data, hit)
        if data is None:
            data = self._read_source(self._sources[i])
        if hit is None:
            hit = self._make_index(data)
        with self._lock:
            for gone in self._touch(self._data_lru, i, self._max_files,
                                    data):
                self._clip_rows.pop(gone, None)  # unregister what is dropped
            self._touch(self._index_lru, i, self._max_indexes, hit)
            return self._register(i, data, hit)

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
        _, idx, ch, *_ = self._entry(i)
        return idx.header.total_values // ch

    def read(self, i: int, start_pcm: int, n_pcm: int) -> np.ndarray:
        """int16 [n, channels] frames from file i (clamped at stream end)."""
        entry = self._entry(i)
        ch = entry[2]
        words = _segment(entry, start_pcm, n_pcm, ch, self._backend,
                         self._device)
        return words.reshape(-1, ch)

    def read_batch(self, files, starts, frames: int, *,
                   pad: bool = True) -> torch.Tensor:
        """int16 [B, frames, channels] crops, crop j of file files[j] from
        frame starts[j], in the order asked, on the corpus's device.

        Crop j is bit-equal to read(files[j], starts[j], frames) followed
        by zero frames up to `frames`: past a clip's decodable end the
        frames are zeros with pad=True, and pad=False raises ValueError
        instead. Every file of one batch must have the same channel count
        (ValueError otherwise); geometries may mix, each taking its own
        unpack and synthesis launch. On a card the call does not
        synchronise: a caller on the same stream reads the tensor in
        order, as a training step does. A file whose coefficients leave
        the amplitude table (BlockIndex.oor) is decoded exactly on the
        host and its crop copied in with the rest. backend="host" returns
        the crops on the CPU from the native host decoder.
        """
        files = [int(i) for i in files]
        starts = [int(s) for s in starts]
        frames = int(frames)
        if len(files) != len(starts):
            raise ValueError(f"{len(files)} files but {len(starts)} starts")
        if not files:
            raise ValueError("read_batch needs at least one crop")
        if frames < 0:
            raise ValueError(f"frames must be >= 0, got {frames}")
        with profiling.call("libacm.random_access.batch", crops=len(files)):
            profiling.count("libacm.random_access.crops", len(files))
            with profiling.span("libacm.random_access.index"):
                entries = [self._entry(i) for i in files]
            chans = sorted({e[2] for e in entries})
            if len(chans) != 1:
                raise ValueError("a batch needs files of one channel count, "
                                 f"got {chans}")
            if self._backend == "host":
                return _crops_on_host(entries, starts, frames, chans[0],
                                      pad, files)
            return _crops_on_device(entries, starts, frames, chans[0],
                                    self._device, pad=pad, files=files)

    @property
    def cached_files(self) -> int:
        return len(self._data_lru)


def _pad_refused(row: int, file: int, start: int, valid: int, frames: int,
                 ch: int) -> ValueError:
    return ValueError(f"crop {row} (file {file}, frame {start}): "
                      f"{valid // ch} of {frames} frames decodable and "
                      "pad=False")


def _host_words(data, start_word: int, valid: int, want: int) -> np.ndarray:
    """A crop's `valid` words from `start_word`, zero-padded to `want`,
    decoded on the host: an exact full decode of a stale-amp-table file
    (the native host decoder reproduces the stale table reads), nothing
    for a crop past its clip's end."""
    out = np.zeros(want, dtype=np.int16)
    if valid:
        with profiling.span("libacm.random_access.host_decode"):
            pcm = native.decode_host(data).pcm
        # copy: the pcm is a view of a refcount-gated pooled buffer
        out[:valid] = pcm[start_word : start_word + valid]
    return out


def _host_crop(entry: tuple, f: list[int], want: int) -> np.ndarray:
    """One planned crop's words (f: its CROP_INFO row of native.scan_crops),
    zero-padded to `want`, by the native host decoder: a host row by
    _host_words, any other crop its span of blocks decoded from its
    warm-up block's bit."""
    data, index = entry[0], entry[1]
    code, _, start_word, valid, nb, _, lo, warm = f
    if code == native.CROP_HOST:
        return _host_words(data, start_word, valid, want)
    a0 = start_word // index.header.block_len - warm
    hd = native.decode_host(data, header=index.header, max_blocks=nb,
                            start_bit=int(index.bitpos[a0]) if a0 else None)
    if hd.n_good != nb:
        raise _stale(nb, hd.n_good)
    out = np.zeros(want, dtype=np.int16)
    out[:valid] = hd.pcm[lo : lo + valid]  # a copy out of the pooled view
    return out


def _crops_on_host(entries, starts: list[int], frames: int, ch: int,
                   pad: bool, files) -> torch.Tensor:
    """read_batch's host route: one plan-only native call for the batch,
    then each crop by _host_crop, on the CPU."""
    status, info = _plan(entries, starts, frames, pad)
    if status != native.CROPS_DONE:
        _raise_for(status, info, files, starts, frames, ch)
    out = np.stack([_host_crop(e, f, frames * ch)
                    for e, f in zip(entries, info.tolist())])
    return torch.from_numpy(out).view(len(entries), frames, ch)


#: staging blobs per thread and card that may be in flight at once
_STAGING_MAX = 8
#: a first frame past the end of any clip, within an int64
_START_MAX = 1 << 62


class _Staging:
    """A pinned host blob and the event recorded after its copy."""

    def __init__(self, nbytes: int):
        self.tensor = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self.array = self.tensor.numpy()
        self.address = self.array.ctypes.data
        self.copied: torch.cuda.Event | None = None

    def free(self) -> bool:
        return self.copied is None or self.copied.query()


def _staging(device: torch.device, nbytes: int) -> _Staging:
    """A pinned blob of at least nbytes for a copy to `device`, free of
    any copy in flight; at _STAGING_MAX in flight, wait for the oldest."""
    pools = getattr(_TLS, "staging", None)
    if pools is None:
        pools = _TLS.staging = {}
    pool: list[_Staging] = pools.setdefault(device, [])
    for s in pool:
        if s.tensor.numel() >= nbytes and s.free():
            pool.remove(s)
            pool.append(s)  # the most recently used last
            return s
    if len(pool) >= _STAGING_MAX:  # every blob in flight: wait
        s = pool.pop(0)
        if s.copied is not None:
            s.copied.synchronize()
        if s.tensor.numel() < nbytes:
            s = _Staging(1 << (nbytes - 1).bit_length())
    else:
        s = _Staging(1 << max(20, (nbytes - 1).bit_length()))
    pool.append(s)
    return s


def _arange(device: torch.device, n: int) -> torch.Tensor:
    """torch.arange(n) on `device`, made once (by a copy that has finished
    when it returns, so any stream may read it)."""
    cache = getattr(_TLS, "arange", None)
    if cache is None:
        cache = _TLS.arange = {}
    key = (device, n)
    if key not in cache:
        cache[key] = torch.arange(n).to(device)
    return cache[key]


def _crop_tables(n: int) -> tuple[np.ndarray, int]:
    """This thread's int64 result array of native.scan_crops, for n crops,
    and its address."""
    have = getattr(_TLS, "crop_tables", None)
    size = native.CROP_HEAD + (native.CROP_GEOM + native.CROP_INFO) * n
    if have is None or len(have[0]) < size:
        a = np.zeros(max(size, 1024), dtype=np.int64)
        have = _TLS.crop_tables = (a, a.ctypes.data)
    return have


def _scan_crops(entries, starts: list[int], frames: int, pad: bool,
                device: torch.device | None):
    """native.scan_crops of the batch into a blob for `device` (pinned for
    a card, a new array for the CPU), called again with a larger blob
    where the layout may not fit; with no device, the plan alone (a null
    blob). Returns (status, the int64 result array, the blob: a _Staging,
    an array or None)."""
    n = len(entries)
    table = b"".join([e[3] for e in entries])
    try:
        firsts = struct.pack(f"{n}q", *starts)
    except struct.error:  # a start beyond int64: past any clip's end
        firsts = struct.pack(f"{n}q", *(min(max(s, 0), _START_MAX)
                                         for s in starts))
    res, res_address = _crop_tables(n)
    need = getattr(_TLS, "crop_blob_bytes", 1 << 20)
    while True:
        if device is None:
            blob, address, cap = None, 0, 0
        elif device.type == "cuda":
            blob = _staging(device, need)
            address, cap = blob.address, blob.tensor.numel()
        else:
            # a CPU tensor aliases its array: never reuse it
            blob = np.empty(need, np.uint8)
            address, cap = blob.ctypes.data, need
        status = native.scan_crops(table, firsts, n, frames, pad, address,
                                   cap, res_address)
        if status != native.CROPS_BLOB_SMALL:
            return status, res, blob
        need = _TLS.crop_blob_bytes = int(res[1])


def _info(res: np.ndarray, n: int) -> np.ndarray:
    """The n CROP_INFO rows of native.scan_crops's result, int64 [n, I]."""
    H, G, I = native.CROP_HEAD, native.CROP_GEOM, native.CROP_INFO
    return res[H + G * n : H + (G + I) * n].reshape(n, I)


def _plan(entries, starts: list[int], frames: int,
          pad: bool) -> tuple[int, np.ndarray]:
    """The batch's plan alone: native.scan_crops's status (CROPS_DONE or
    CROPS_PAD_REFUSED) and its CROP_INFO rows (a view of this thread's
    result array: read it before the thread's next call)."""
    status, res, _ = _scan_crops(entries, starts, frames, pad, None)
    return status, _info(res, len(entries))


def _raise_for(status: int, info: np.ndarray, files, starts, frames: int,
               ch: int):
    """The ValueError of a batch native.scan_crops refused: the first crop
    short of its frames with pad=False, else the stale geometry's first
    crop whose span starts past its bytes, else its first that decoded
    fewer blocks than its index says."""
    codes = info[:, 0].tolist()
    if status == native.CROPS_PAD_REFUSED:
        j = codes.index(native.CROP_PAD)
        raise _pad_refused(j, files[j], starts[j], int(info[j, 3]), frames,
                           ch)
    past = native.CROP_PAST in codes
    j = codes.index(native.CROP_PAST if past else native.CROP_STALE)
    raise _stale(int(info[j, 4]), 0 if past else int(info[j, 5]))


def _crops_on_device(entries, starts: list[int], frames: int, ch: int,
                     device: torch.device, *, pad: bool = True,
                     files=None) -> torch.Tensor:
    """read_batch's device route over `entries` (each crop's entry, as
    RandomAccessCorpus._entry gives it, in batch order): one native call
    plans the crops, scans their spans and lays out the blob, copied in
    once; one unpack and one synthesis launch a geometry, then the
    gather. `files` names the crops in the pad=False error."""
    from ..ops.synth_torch import synth_pcm_cols_blob

    B, want = len(entries), frames * ch
    if not want:
        return torch.zeros((B, frames, ch), dtype=torch.int16, device=device)
    H, G = native.CROP_HEAD, native.CROP_GEOM
    # a batch of stale-amp-table clips alone has no span to scan
    scans = any(not e[1].oor for e in entries)
    with (profiling.span("libacm.random_access.scan") if scans
          else profiling.OFF):
        status, res, blob = _scan_crops(entries, starts, frames, pad, device)
    if status != native.CROPS_DONE:
        _raise_for(status, _info(res, B), files, starts, frames, ch)
    _, total, n_geo, n_host, host_off, meta_off, n_dev, reordered = (
        res[:H].tolist())
    geos = res[H : H + G * n_geo].reshape(n_geo, G).tolist()
    for g in geos:
        profiling.count("libacm.random_access.blocks", g[2] * g[3])
        profiling.count("libacm.random_access.warmup_blocks", g[12])
        profiling.count("libacm.random_access.pad_blocks", g[13])
    if n_dev:
        profiling.count("libacm.random_access.native_crops", n_dev)
    stage = blob if isinstance(blob, _Staging) else None
    if n_host:  # host-decoded rows, in batch order, where the call left room
        host = stage.array if stage is not None else blob
        info = _info(res, B)
        o = host_off
        for j in np.flatnonzero(info[:, 0] == native.CROP_HOST).tolist():
            host[o : o + 2 * want] = _host_words(
                entries[j][0], int(info[j, 2]), int(info[j, 3]),
                want).view(np.uint8)
            o += 2 * want

    with profiling.span("libacm.random_access.copy") as sp:
        if stage is None:
            dev_blob = torch.from_numpy(blob[:total])
        else:
            dev_blob = stage.tensor[:total].to(device, non_blocking=True)
            if stage.copied is None:
                stage.copied = torch.cuda.Event()
            stage.copied.record(torch.cuda.current_stream(device))
            if sp.recording:
                profiling.count("libacm.copy.h2d_bytes.pinned", total)

    with profiling.span("libacm.random_access.launch"):
        meta_dev = dev_blob[meta_off:total].view(torch.int64)
        outs, m = [], 0
        for (level, rows, count, nbp, o, size, *lens, _, _, short,
             lo0) in geos:
            pcm, _ = synth_pcm_cols_blob(
                dev_blob[o : o + size], level=level, rows=rows, batch=count,
                nb=nbp, backend="cuda", lens=tuple(lens))
            lo = meta_dev[m : m + count]
            valid = meta_dev[m + count : m + 2 * count]
            m += 2 * count
            # one crop (a segment read): a view of its row, no gather
            got = (pcm.view(1, -1)[:, lo0 : lo0 + want] if count == 1 else
                   pcm.view(count, -1).gather(
                       1, lo[:, None] + _arange(device, want)))
            if short:  # zeros past a clip's end
                got = torch.where(_arange(device, want) < valid[:, None],
                                  got, 0)
            outs.append(got)
        if n_host:
            outs.append(dev_blob[host_off : host_off + 2 * want * n_host]
                        .view(torch.int16).view(n_host, want))
        out = torch.cat(outs) if len(outs) > 1 else outs[0]
        if reordered:
            out = out.index_select(0, meta_dev[m:])
    return out.view(B, frames, ch)


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
    card, or $LIBACM_TPU_TORCH_DEVICE; raises without one) by
    read_batch's device route with one crop: the span's cols-wire, copied
    in one blob, unpacked and synthesized by the corpus path's kernel
    wrapper (the CUDA kernel on a card, its plain version on the CPU),
    then the crop fetched. backend="host" decodes the span with the fused
    native host decoder (one C++ sweep; the JAX package's default route).
    Both routes raise ValueError for an index that no longer fits the
    bytes.
    """
    _check_backend(backend)
    dev = None if backend == "host" else resolve_device(device)
    return _segment((data, index, 1), start_word, n_words, 1, backend, dev)


def _segment(entry: tuple, start: int, n: int, ch: int, backend,
             dev) -> np.ndarray:
    """The words of frames [start, start + n) of `entry`'s clip (clamped
    at its decodable end): a batch of one crop, planned by one plan-only
    native call, then decoded on the host (backend="host", or a
    stale-amp-table clip) or by read_batch's device route. `entry` is
    (bytes, BlockIndex, channels), followed by its row of the native crop
    table and what that points into where the caller has registered it."""
    data, index = entry[0], entry[1]
    if len(entry) == 3:
        entry += native.clip_row(data, index.bitpos, index.header,
                                 index.n_good, ch, index.oor)
    # within an int64: no clip holds more frames than words
    frames = min(max(0, n), index.header.total_values)
    f = _plan([entry], [start], frames, True)[1][0].tolist()
    valid = f[3]
    if not valid:
        return np.zeros(0, dtype=np.int16)
    if backend == "host" or f[0] == native.CROP_HOST:
        return _host_crop(entry, f, valid)
    return _crops_on_device([entry], [start], valid // ch, ch,
                            dev).view(-1).cpu().numpy()
