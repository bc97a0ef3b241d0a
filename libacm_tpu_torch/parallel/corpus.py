"""Corpus-scale batched decode with PCM left on the device.

Counterpart of `libacm_tpu/parallel/corpus.py` for one torch device or a
list of them (`devices=[...]`; torch has no mesh, the list is the mesh):

  host:   read each file's header, bucket files by (level, rows, padded
          block count) — the shape key — and for each chunk of a bucket run
          the C++ scanner over all its files at once, writing the
          exact-width cols-wire (class map, bit-packed column streams,
          width nibbles, vals). The scans run on a small pool of
          long-lived scanner threads (`_scan_workers()`: the CPUs the
          process may use less two, at most 6), one task per device group
          of a chunk, several chunks ahead of the calling thread, which
          takes them back in chunk order;
  link:   the chunk's wire sections are coalesced into one byte blob and
          copied to the device (`torch.from_numpy(blob).to(device)`) on a
          single submitter thread, in chunk order, so the scans of the
          next chunks overlap chunk N's copy and dispatch;
  device: slice the blob, unpack the columns (tensor ops) and synthesize
          (the CUDA kernel of ops.synth_cuda on a card; its plain version
          on the CPU);
  host:   per-file slice/clamp with the reference CLI's exact stop
          semantics and per-file error isolation (a corrupt file yields a
          status, never kills the batch).

`decode_corpus_device` leaves the PCM on the device (`DeviceCorpus`);
`decode_corpus` returns per-file host results: decoded on the card and
fetched, or, when the caller asks for the CPU, from the fused native host
decoder.

With a device list, each chunk's files are cut into one contiguous group
per device; every group is scanned on its own (payload offsets restart per
group), coalesced into its own blob, copied to its own device and decoded
there: no collectives, and no device ever reads another's wire. What the
JAX package needs only for `shard_map` is left out: one blob layout for
all shards, every group padded to the same file count, payloads cut to a
common 4096-rounded length. Here a group may be shorter than the others,
or empty.

`decode_stream_device` decodes ONE stream through the same pipeline in
windows of W blocks, the filterbank carry handed from window to window on
the device, and over a device list with each window's blocks cut into one
span per device.

Per-file error/EOF semantics mirror the reference *CLI* consumer
(`acmtool.c:269-310`): decode errors are swallowed whenever the 8 KiB
read chunk already holds data (util.c:271-272) and fatal only at chunk
boundaries — see cli_stop_words. `filler_words` reports how many zero
words the CLI would append to reach the declared length.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Sequence, Union

import numpy as np
import torch

from ..device import Device
from ..device import resolve_device as _resolve_device
from ..device import resolve_devices as _resolve_devices
from ..format import (
    ACM_EXPECTED_EOF,
    ACM_ID,
    ACMInfo,
    AcmError,
    AcmException,
    AcmHeader,
    cli_total_bytes as _cli_total_bytes,
    resolve_channels,
)
from ..scan import scan_bytes
from ..scan.oracle import BitReader, parse_header
from ..utils import profiling

logger = logging.getLogger("libacm_tpu_torch.corpus")

Source = Union[str, os.PathLike, bytes, bytearray]


@dataclasses.dataclass
class FileResult:
    """Outcome of one corpus file (error-isolated)."""

    index: int
    info: ACMInfo | None
    #: int16 interleaved PCM words actually decoded (None if open failed).
    pcm: np.ndarray | None
    #: 0 on clean decode; else the first AcmError hit (ERR_NOT_ACM for
    #: unparseable files, ERR_CORRUPT / ERR_UNEXPECTED_EOF mid-stream).
    status: int
    #: zero words the reference CLI would append to reach the declared
    #: length (acmtool.c:293-310); 0 for a full decode.
    filler_words: int = 0

    @property
    def ok(self) -> bool:
        return self.status == 0


def cli_stop_words(events: np.ndarray, block_len: int, total: int,
                   channels: int, req_words: int = 4096) -> int:
    """Words `acmtool -d` would emit for a stream with these decode events.

    The reference CLI reads 8 KiB (4096-word) chunks via acm_read_loop
    (acmtool.c:269-291) whose partial-data-wins rule (util.c:271-272)
    SWALLOWS a decode error whenever any data was already read in that
    call — decoding then continues with the next block. An error stops the
    CLI only when it surfaces at a chunk boundary. This simulates the exact
    acm_read call-by-call arithmetic (decode.c:826-876) over the scan's
    event list: returns the emitted word count (error-truncated, channel-
    clamped, total-clamped).
    """
    pos = 0
    bpos = 0
    ready = False
    ei = 0
    while True:
        got = 0
        err = False
        left = req_words
        while left > 0:
            # --- one acm_read(left words) ---
            if pos >= total:
                break  # EOF, res=0
            if not ready:
                if ei >= len(events):
                    break  # clean EOF
                ev = int(events[ei])
                ei += 1
                if ev != 0:
                    err = True  # error code returned by this acm_read
                    break
                ready = True
                bpos = 0
            nw = min(left, block_len - bpos, total - pos)
            if channels > 1:
                nw -= nw % channels
            if nw <= 0:
                break  # wedged (stranded word); read_loop sees 0 bytes
            pos += nw
            bpos += nw
            got += nw
            left -= nw
            if bpos == block_len:
                ready = False
        if err and got == 0:
            return pos  # error surfaced at a chunk boundary: CLI stops
        if got == 0:
            return pos  # EOF / wedge
        # partial data wins: the error (if any) was swallowed; next call
        # re-enters decode_block after the failed attempt, like the C


def effective_stop(total: int, block_len: int, channels: int, words_avail: int) -> int:
    """Word position where the reference's read loop stops.

    Replays acm_read's per-call clamping (decode.c:848-857): each call takes
    min(remaining-in-block, total - pos) rounded down to a channel multiple;
    a zero-word round ends the stream (including the odd-block_len stereo
    wedge, where a final stranded word is never returned).
    """
    lim = min(total, words_avail)
    if channels <= 1:
        return lim
    if block_len % channels == 0:
        # pos stays block- and channel-aligned through every full-block
        # call, so only the final partial call rounds: closed form
        return lim - (lim % channels)
    pos = 0
    while pos < lim:
        in_block = block_len - (pos % block_len)
        nw = min(in_block, lim - pos)
        nw -= nw % channels
        if nw <= 0:
            break
        pos += nw
    return pos


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_blocks(nb: int) -> int:
    """Pad a block count to limit shape variants without pow2 waste."""
    if nb <= 8:
        return max(1, nb)
    if nb <= 32:
        return _round_up(nb, 8)
    return _round_up(nb, 32)


def _read_source(src: Source) -> bytes:
    if isinstance(src, (bytes, bytearray)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def _reread_source(src: Source) -> bytes | None:
    """Full stream bytes from the START, for a source that may already
    have been consumed. None when the source cannot be rewound (read()-only
    object): the caller must fail loudly, not decode a tail as if it were
    the stream."""
    if isinstance(src, (bytes, bytearray)):
        return bytes(src)
    if hasattr(src, "read"):
        if not hasattr(src, "seek"):
            return None
        try:
            src.seek(0)
        except (OSError, ValueError):
            return None
        return bytes(src.read())
    return _read_source(src)  # path-like: reopen


def _peek_source(src: Source, n: int = 64) -> tuple[bytes, int]:
    """(first n bytes, total byte length) without slurping file sources.

    The bucketing pass needs only the header (<= 48 bytes) and the file
    size; reading whole files here would make a large ingest hold the
    entire corpus in host memory up-front.
    """
    if isinstance(src, (bytes, bytearray)):
        return bytes(src[:n]), len(src)
    with open(src, "rb") as f:
        head = f.read(n)
        size = os.fstat(f.fileno()).st_size
    return head, size


@dataclasses.dataclass
class _FileEntry:
    index: int
    #: original source; bytes are (re)loaded per chunk at scan time and
    #: released after — corpus host memory stays O(chunk), not O(corpus)
    src: Source
    header: AcmHeader
    channels: int
    nbytes: int
    # filled at scan time:
    n_good: int = 0  # committed (successful) blocks, errors skipped over
    #: file vanished between the header peek and the chunk scan: the
    #: result becomes FileResult(pcm=None, status=ERR_OPEN)
    open_failed: bool = False
    first_err: int = 0
    #: per-attempt outcome list (0 = block, negative = error) — drives the
    #: CLI-equivalent stop position (see cli_stop_words)
    events: np.ndarray | None = None
    #: exact host-decoded PCM override (stale-amp-table streams take the
    #: host path; the device result for this file is ignored)
    host_pcm: np.ndarray | None = None

    def load_data(self) -> bytes:
        """File bytes; a vanished file marks the entry failed and decodes
        as zero blocks (the batch stays alive, the result is ERR_OPEN)."""
        try:
            return _read_source(self.src)
        except OSError:
            self._mark_open_failed()
            return b""

    def load_into(self, mv: memoryview, pos: int, cap: int) -> int:
        """Read up to cap file bytes straight into mv[pos:], returning the
        byte count (0 and open_failed on a vanished file)."""
        try:
            src = self.src
            if isinstance(src, (bytes, bytearray)):
                n = min(len(src), cap)
                mv[pos : pos + n] = memoryview(src)[:n]
                return n
            with open(src, "rb") as f:
                return f.readinto(mv[pos : pos + cap]) or 0
        except OSError:
            self._mark_open_failed()
            return 0

    def _mark_open_failed(self) -> None:
        self.open_failed = True
        self.n_good = 0
        self.first_err = int(AcmError.ERR_OPEN)
        self.events = np.zeros(0, dtype=np.int16)


@dataclasses.dataclass
class _BucketOut:
    """Device-side output of one chunk (all same (level, rows, nb))."""

    level: int
    rows: int
    entries: list[_FileEntry]
    pcm: torch.Tensor  # int16 [B, nb, rows*cols]; entries[j] is row j


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    """Batch-job configuration, one frozen value so jobs are reproducible.

    The reference's config surface is CLI flags + `force_chans`; corpus
    jobs add scheduling knobs.
    """

    force_chans: int = 0
    #: files per device dispatch; None = auto-size so each chunk carries
    #: ~16M samples
    chunk_files: int | None = None
    pack: bool = True
    #: decode_corpus's route: "auto" decodes on the device (the native host
    #: decoder when the device is the CPU), "host" requires the native host
    #: decoder. decode_corpus_device takes "auto" only.
    backend: str = "auto"
    #: decode threads for the host path (the fused native decoder releases
    #: the GIL with thread-local scratch); ignored by the device path
    host_workers: int = 1


@dataclasses.dataclass
class CorpusSummary:
    """Observability counters for one corpus decode."""

    n_files: int = 0
    n_ok: int = 0
    n_failed: int = 0  # unreadable / not-ACM
    n_partial: int = 0  # decoded with a mid-stream error status
    samples: int = 0
    wall_s: float = 0.0
    #: wall seconds of the calling thread in the host scan: the time it
    #: spends blocked on the scanner threads' scans (the staging, the
    #: native scan and the host decodes of every device's group), Σ
    #: `libacm.corpus.scan.wait` while recording
    scan_s: float = 0.0

    @property
    def msamples_per_s(self) -> float:
        return self.samples / self.wall_s / 1e6 if self.wall_s else 0.0

    def realtime_factor(self, rate: int = 22050) -> float:
        return self.msamples_per_s * 1e6 / rate

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["msamples_per_s"] = round(self.msamples_per_s, 2)
        return d


class DeviceCorpus:
    """Decoded corpus with PCM left on the device, or on the devices of a
    list: each chunk's tensor lies where its group was decoded."""

    def __init__(self, n_files: int, devices: Sequence[torch.device]):
        self._n = n_files
        #: the devices the corpus was decoded over, as the caller gave them
        self.devices = list(devices)
        self._buckets: list[_BucketOut] = []
        self._failed: dict[int, FileResult] = {}
        self.summary = CorpusSummary(n_files=n_files)

    # -- construction (internal) -------------------------------------------

    def _add_failed(self, r: FileResult) -> None:
        self._failed[r.index] = r

    def _add_bucket(self, b: _BucketOut) -> None:
        self._buckets.append(b)

    # -- consumption ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The first device of the list (the only one of a single-device
        decode)."""
        return self.devices[0]

    def block_until_ready(self) -> "DeviceCorpus":
        """Wait until every queued kernel on every device used has
        finished."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    def checksum(self) -> int:
        """Device-side digest of all decoded PCM; fetches one scalar.

        Padded rows/blocks are masked out (a padded all-zero block still
        synthesizes nonzero PCM via the rounding bias and inherited
        carry), so the digest depends only on corpus content — the same
        value for any chunk_files, backend or device list. Each device
        sums its own chunks and the per-device sums (one scalar each) add
        on the host. The int64 sum taken & 0xFFFFFFFF equals the JAX
        package's wrapped int32 sum modulo 2^32. On a card the sum is one
        kernel launch over the device's chunks (ops/checksum_cuda.py); on
        the CPU it is the same masked sum as torch ops.

        The digest is of what lies on the device, as in the JAX package.
        For a stale-amp-table file (hostile streams only) that is the
        k*val synthesis of the file's slot, while to_results() hands back
        the host decoder's exact PCM for it: for such a file the digest
        does not describe the results. It is a check that two decodes
        left the same tensors on the device, not a digest of the results.
        """
        with profiling.call("libacm.corpus.checksum"):
            return _sum_all(self._buckets)

    def device_arrays(self) -> list[tuple[list[int], torch.Tensor]]:
        """[(file_indices, int16 pcm [B, nb, block_len])] per chunk (per
        device group of a chunk), each tensor on the device it was decoded
        on."""
        return [([e.index for e in b.entries], b.pcm) for b in self._buckets]

    def to_results(self) -> list[FileResult]:
        """Fetch PCM to host and apply per-file reference stop semantics;
        results are in source order whatever the grouping.

        A stale-amp-table file's PCM is the host decoder's exact decode,
        not its device slot (which checksum() and device_arrays() see):
        only the host's virtual amp table reproduces the reference there.
        """
        results: list[FileResult | None] = [None] * self._n
        for i, r in self._failed.items():
            results[i] = r
        for b in self._buckets:
            block_len = b.rows << b.level
            host = b.pcm.cpu().numpy()
            for j, e in enumerate(b.entries):
                results[e.index] = _finalize(e, host[j].reshape(-1),
                                             block_len)
        return results  # type: ignore[return-value]


def _checksum_inputs(
        buckets: Sequence[_BucketOut]) -> dict[torch.device, tuple]:
    """{device: ([pcm int16 [B, nb, L]], [n_good int64 [B]])} of the
    chunks on each device (rows past the chunk's files count 0)."""
    by_dev: dict[torch.device, tuple[list, list]] = {}
    for b in buckets:
        pcms, ngs = by_dev.setdefault(b.pcm.device, ([], []))
        ng = np.zeros(b.pcm.shape[0], dtype=np.int64)
        ng[: len(b.entries)] = [e.n_good for e in b.entries]
        pcms.append(b.pcm)
        ngs.append(ng)
    return by_dev


def _sum_all(buckets: Sequence[_BucketOut]) -> int:
    """Masked content digest of the chunks (DeviceCorpus.checksum): each
    device's chunks in one ops.checksum_cuda.sum_all call (the kernel on a
    card, torch ops on the CPU), every device's sum queued before the
    first is fetched; the sums add on the host, modulo 2^32."""
    from ..ops import checksum_cuda

    sums = [checksum_cuda.sum_all(*chunks)
            for chunks in _checksum_inputs(buckets).values()]
    return sum(int(t.item()) for t in sums) & 0xFFFFFFFF


def _finalize(e: _FileEntry, pcm_flat: np.ndarray, block_len: int) -> FileResult:
    if e.open_failed:
        return FileResult(index=e.index, info=None, pcm=None,
                          status=int(AcmError.ERR_OPEN))
    h = e.header
    if e.host_pcm is not None:
        pcm_flat = e.host_pcm
    total_bytes = _cli_total_bytes(h.total_values, e.channels)
    if total_bytes <= 0:
        info = ACMInfo(
            channels=e.channels, rate=h.rate, acm_id=ACM_ID, acm_version=1,
            acm_channels=h.channels, acm_level=h.level, acm_cols=h.cols,
            acm_rows=h.rows,
        )
        return FileResult(index=e.index, info=info,
                          pcm=np.zeros(0, dtype=np.int16),
                          status=e.first_err if e.first_err not in
                          (0, ACM_EXPECTED_EOF) else 0,
                          filler_words=0)
    if e.events is not None and e.first_err != 0:
        # errors present (first_err is the first nonzero event): replicate
        # the CLI's exact stop position (errors are swallowed mid-chunk,
        # fatal at chunk boundaries)
        stop = cli_stop_words(e.events, block_len, h.total_values, e.channels)
    else:
        stop = effective_stop(h.total_values, block_len, e.channels,
                              e.n_good * block_len)
    want = h.total_values - (h.total_values % e.channels if e.channels > 1 else 0)
    status = 0
    if e.first_err not in (0, ACM_EXPECTED_EOF):
        status = e.first_err
    info = ACMInfo(
        channels=e.channels, rate=h.rate, acm_id=ACM_ID, acm_version=1,
        acm_channels=h.channels, acm_level=h.level, acm_cols=h.cols,
        acm_rows=h.rows,
    )
    return FileResult(
        index=e.index, info=info, pcm=pcm_flat[:stop], status=status,
        filler_words=max(0, want - stop),
    )


def _apply_host_decode(e: _FileEntry, hd) -> None:
    """Copy a native HostDecode result into a _FileEntry."""
    e.n_good = hd.n_good
    e.first_err = hd.first_err
    e.events = hd.events
    e.host_pcm = hd.pcm


def _host_decode_fallback(e: _FileEntry, data: bytes | None = None) -> None:
    """Exact host decode for stale-amp-table streams.

    Rare (corrupt/hostile streams only): the k*val dequantization the
    device performs cannot reproduce the reference's stale table reads, so
    the file's PCM comes from the fused native host decoder (its virtual
    table reproduces the stale reads) or, without the native library, the
    oracle; the device output for this file's slot is ignored."""
    if data is None:
        data = e.load_data()
    from ..scan import native as _native

    if _native.available():
        _apply_host_decode(e, _native.decode_host(data, e.header))
        return
    from ..scan import oracle as _oracle

    scan = _oracle.scan_bytes(data)
    e.n_good = scan.n_blocks
    _, e.first_err = _n_good(scan.events)
    e.events = scan.events
    e.host_pcm = _oracle.words_to_pcm(_oracle.synth_all(scan),
                                      e.header.level)


def _n_good(events: np.ndarray) -> tuple[int, int]:
    """(blocks before first failed attempt, first error or 0)."""
    ng = 0
    for ev in events:
        if ev != 0:
            return ng, int(ev)
        ng += 1
    return ng, 0


_SCAN_TLS = threading.local()


class _WireBufs:
    """One chunk's reusable host wire buffers, and what may still read them.

    Reuse needs only a small memset of the metadata arrays: the payload
    pools are written append-only up to their counters and the device
    unpack never reads past them, so stale tail bytes are never observed.
    A buffer set is free once the dispatch that coalesces it has run
    (`fut`) and the copy of its blob to the device has finished
    (`copied`, a CUDA event recorded after the copy).
    """

    def __init__(self, b: int, nb: int, level: int, rows: int,
                 device: torch.device):
        from ..scan.native import pay_stream_caps

        cols = 1 << level
        ncols_cap = b * nb * cols
        c4, c8, c16, cw = pay_stream_caps(ncols_cap, rows)
        self.key = (b, nb, level, rows, device)
        self.cls = np.zeros((b, nb, (cols + 3) // 4), dtype=np.uint8)
        self.pwr = np.zeros((b, nb), dtype=np.uint8)
        self.vals = np.zeros((b, nb), dtype=np.uint16)
        self.wrap0 = np.zeros((b, 2 * cols - 2), dtype=np.int32)
        self.pay4 = np.empty(c4, dtype=np.uint8)
        self.pay8 = np.empty(c8, dtype=np.uint8)
        self.pay16 = np.empty(c16, dtype=np.uint8)
        self.wid4 = np.empty(cw, dtype=np.uint8)
        self.wid8 = np.empty(cw, dtype=np.uint8)
        self.wid16 = np.empty(cw, dtype=np.uint8)
        # coalesced single-copy wire blob (capacity = worst case of every
        # section; actual chunks use a prefix)
        self.blob = np.empty(
            self.cls.nbytes + self.vals.nbytes + self.wrap0.nbytes
            + c4 + c8 + c16 + 3 * cw, dtype=np.uint8)
        self.fut = None  # dispatch that coalesces and copies these buffers
        self.copied = None  # torch.cuda.Event recorded after the copy

    def free(self) -> bool:
        if self.fut is not None and not self.fut.done():
            return False
        return self.copied is None or self.copied.query()

    def reset(self) -> None:
        # metadata must be zero (class codes drive the device cumsum
        # gather; vals of padded blocks feed the checksum) — payloads not
        self.cls[:] = 0
        self.pwr[:] = 0
        self.vals[:] = 0
        self.fut = None
        self.copied = None


class _NeverDone:
    """Placeholder future: pins a _WireBufs as in use between its scan and
    the attachment of the real dispatch future."""

    @staticmethod
    def done() -> bool:
        return False


_SCAN_HOLD = _NeverDone()


def _acquire_wire_bufs(b: int, nb: int, level: int, rows: int,
                       device: torch.device) -> _WireBufs:
    # torch.from_numpy aliases host memory, and .to("cpu") keeps the alias,
    # so a reused buffer would corrupt live CPU tensors: pool only for a
    # target device that the blob is copied to.
    if device.type == "cpu":
        return _WireBufs(b, nb, level, rows, device)
    pool: list[_WireBufs] = getattr(_SCAN_TLS, "wire_pool", None)
    if pool is None:
        pool = _SCAN_TLS.wire_pool = []
    key = (b, nb, level, rows, device)
    for w in pool:
        if w.key == key and w.free():
            w.reset()
            return w
    # bound pool growth, but never below the in-flight window
    if len(pool) > 24:
        free = [w for w in pool if w.free()]
        busy = [w for w in pool if not w.free()]
        pool[:] = busy + free[:8]
    w = _WireBufs(b, nb, level, rows, device)
    pool.append(w)
    return w


def _scan_cols_wire(chunk: list[_FileEntry], level: int, rows: int, nb: int,
                    device: torch.device):
    """Host half of the cols-wire path: ONE batched native scan over the
    whole chunk (file bytes staged back to back in a thread-local blob),
    writing straight into the chunk's (pooled) wire buffers. Returns
    (arrays, _WireBufs) — the caller attaches the dispatch future to the
    buffer set so it is not reused while the dispatch may still read it."""
    from ..format import ACM_HEADER_LEN, WAVC_HEADER_LEN
    from ..scan import native as _native

    b = len(chunk)
    w = _acquire_wire_bufs(b, nb, level, rows, device)

    bufs = _native.scan_buffers(max(e.nbytes for e in chunk))

    # stage file bytes back to back (readinto: no intermediate bytes
    # objects); a file that grew since the header peek is scanned at its
    # peeked size (its bucket was chosen from that size)
    total = sum(e.nbytes for e in chunk)
    blob = getattr(_SCAN_TLS, "blob", None)
    if blob is None or len(blob) < total:
        blob = _SCAN_TLS.blob = np.empty(total + total // 4 + 4096,
                                         dtype=np.uint8)
    mv = memoryview(blob)
    offs = np.zeros(b, dtype=np.int64)
    lens = np.zeros(b, dtype=np.int64)
    skips = np.zeros(b, dtype=np.int64)
    maxbs = np.zeros(b, dtype=np.int64)
    pos = 0
    with profiling.span("libacm.corpus.scan.stage"):
        for j, e in enumerate(chunk):
            n = e.load_into(mv, pos, e.nbytes)
            offs[j] = pos
            lens[j] = n
            pos += n
            skips[j] = 8 * (ACM_HEADER_LEN
                            + (WAVC_HEADER_LEN if e.header.wavc_file else 0))
            maxbs[j] = min(e.header.n_blocks, nb)

    ev_cap = nb + 64
    with profiling.span("libacm.corpus.scan.native"):
        out, events, ncol, bits = _native.scan_corpus_chunk(
            blob, offs, lens, skips, maxbs, level, rows,
            w.cls, w.pwr, w.vals, w.pay4, w.pay8, w.pay16,
            w.wid4, w.wid8, w.wid16, bufs, ev_cap,
        )
    for j, e in enumerate(chunk):
        if e.open_failed:
            continue  # slot stays zeroed; _finalize reports ERR_OPEN
        ng, err, oor, nev, ovf = (int(x) for x in out[j])
        e.n_good, e.first_err = ng, err
        if not (ovf or oor):
            e.events = events[j, :nev].copy()
            continue
        with profiling.span("libacm.corpus.scan.host_decode",
                            rescan=bool(ovf), fallback=bool(oor)):
            data = bytes(mv[offs[j] : offs[j] + lens[j]])
            # heavily corrupt stream: the event list overflowed the
            # per-file cap — rescan solo for the full CLI stop-semantics
            # input
            e.events = (_native.scan_bytes_packed(data).events if ovf
                        else events[j, :nev].copy())
            if oor:
                _host_decode_fallback(e, data)

    # payload pools are append-only up to the counters; padding slices to
    # stable 4096-byte shapes may expose stale (never-gathered) bytes.
    # Even lengths are load-bearing: the device unpack reads streams as
    # uint16 pairs.
    def _pay(a: np.ndarray, used_bits: int) -> np.ndarray:
        return a[: min(_round_up(-(-used_bits // 8) + 2, 4096), len(a))]

    def _wid(a: np.ndarray, n_cols: int) -> np.ndarray:
        return a[: min(_round_up(-(-n_cols // 2), 512), len(a))]

    return (w.cls, _pay(w.pay4, bits[0]), _pay(w.pay8, bits[1]),
            _pay(w.pay16, bits[2]), _wid(w.wid4, ncol[0]),
            _wid(w.wid8, ncol[1]), _wid(w.wid16, ncol[2]),
            w.vals, w.wrap0), w


def _coalesce_wire(arrays, wirebufs=None) -> tuple[np.ndarray, tuple]:
    """Pack the nine wire sections into ONE contiguous uint8 buffer.

    One copy to the device per chunk, sliced back apart on the device at
    the offsets of ops.synth_torch.cols_blob_layout — the order here must
    match it: cls, pay4/8/16, wid4/8/16, vals, wrap0. The memcpy runs on
    the submitter thread, overlapped with the main thread's scan of the
    next chunk. The buffer is the wire buffers' own blob when it fits,
    else a new array. Returns (blob view, payload/width section
    lengths)."""
    sections = tuple(arrays)
    lens = tuple(a.nbytes for a in sections[1:7])
    total = sum(a.nbytes for a in sections)
    if wirebufs is not None and len(wirebufs.blob) >= total:
        blob = wirebufs.blob
    else:
        blob = np.empty(total, np.uint8)
    off = 0
    for a in sections:
        n = a.nbytes
        blob[off : off + n] = a.reshape(-1).view(np.uint8)
        off += n
    return blob[:total], lens


def _dispatch_cols_wire(groups, level: int, rows: int, nb: int,
                        root=profiling.OFF, index: int = 0
                        ) -> list[_BucketOut]:
    """Device half of one chunk: for each (files, wire arrays, wire
    buffers, device) group, copy the coalesced wire blob to its device
    and run the slice + unpack + synthesis there (the kernel wrapper: the
    CUDA kernel on a card, its plain version on the CPU). The kernels of
    one group are queued before the next group's copy starts, so distinct
    devices work side by side. `root` is the calling decode's root span
    and `index` the chunk's number in it, for the spans of this (the
    submitter) thread."""
    from ..ops.synth_torch import synth_pcm_cols_blob

    outs = []
    with profiling.span("libacm.corpus.dispatch", root, chunk=index) as sp:
        for chunk, arrays, wirebufs, device in groups:
            with profiling.span("libacm.corpus.coalesce"):
                blob, lens = _coalesce_wire(arrays, wirebufs)
            with profiling.span("libacm.corpus.copy"):
                host = torch.from_numpy(blob)
                dev = host.to(device)
                if device.type == "cuda":
                    # on the stream of the device the blob was copied to
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(device))
                    wirebufs.copied = ev  # pool reuse waits for this copy
            if sp.recording and device.type != "cpu":
                profiling.count("libacm.copy.h2d_bytes."
                                + ("pinned" if host.is_pinned()
                                   else "pageable"), blob.nbytes)
            with profiling.span("libacm.corpus.launch"):
                pcm, _ = synth_pcm_cols_blob(
                    dev, level=level, rows=rows, batch=len(chunk), nb=nb,
                    backend="cuda", lens=lens,
                )
            outs.append(_BucketOut(level=level, rows=rows, entries=chunk,
                                   pcm=pcm))
    return outs


def _shard(chunk: list, n: int) -> list[list]:
    """Contiguous groups of ceil(len/n) files, one per device; trailing
    groups may be shorter or empty."""
    per = -(-len(chunk) // n)
    return [chunk[s * per : (s + 1) * per] for s in range(n)]


#: most scanner threads: past about this many the submitter thread, not
#: the scan, sets the pace of a pass (an H100's host, 8 and 32 cores)
_SCAN_WORKERS_MAX = 6


def _scan_workers() -> int:
    """Scanner threads of the corpus path: the CPUs this process may use,
    less one for the calling thread and one for the submitter, at least 1
    and at most _SCAN_WORKERS_MAX."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        n = os.cpu_count() or 1
    return max(1, min(_SCAN_WORKERS_MAX, n - 2))


_SCANNER_LOCK = threading.Lock()
#: (pid, workers, executor) of the process's scanner pool
_SCANNER: tuple[int, int, ThreadPoolExecutor] | None = None


def _scanner() -> tuple[int, ThreadPoolExecutor]:
    """The process's scanner pool, made on first use and kept: each of
    its threads keeps its own scan scratch, staging blob and wire-buffer
    pool (`_SCAN_TLS`) from call to call. Made again only in a forked
    child (the parent's threads are not there) or where _scan_workers()
    answers otherwise."""
    global _SCANNER
    n = _scan_workers()
    with _SCANNER_LOCK:
        if _SCANNER is None or _SCANNER[:2] != (os.getpid(), n):
            _SCANNER = (os.getpid(), n, ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="libacm-scan"))
        return n, _SCANNER[2]


class _ScanCall:
    """The scans of one decode call that are running now."""

    def __init__(self):
        self.lock = threading.Lock()
        self.running = 0


def _scan_group(group: list[_FileEntry], level: int, rows: int, nb: int,
                device: torch.device, root, call: _ScanCall):
    """One scanner task: the host scan of one device group of a chunk,
    in the span `libacm.corpus.scan` under the call's root. Returns
    (arrays, _WireBufs, whether another scan of the call was running when
    it started), the buffers held."""
    with call.lock:
        overlapped = call.running > 0
        call.running += 1
    try:
        with profiling.span("libacm.corpus.scan", root, device=device.index,
                            files=len(group)):
            arrays, w = _scan_cols_wire(group, level, rows, nb, device)
            # hold the buffers before this thread takes another task: two
            # groups share a pool key when the list names a device twice,
            # and until the dispatch future exists free() would hand this
            # group's buffers to the next one (reset + payload overwrite
            # -> wrong PCM here)
            w.fut = _SCAN_HOLD
    finally:
        with call.lock:
            call.running -= 1
    return arrays, w, overlapped


def decode_corpus_device(
    sources: Sequence[Source],
    *,
    device: Device = None,
    devices: Sequence[Device] | None = None,
    force_chans: int = 0,
    chunk_files: int | None = None,
    pack: bool = True,
    config: CorpusConfig | None = None,
) -> DeviceCorpus:
    """Decode a corpus; leave PCM on `device` (see DeviceCorpus).

    `device=None` is the card (torch.device("cuda")), or the device named
    by $LIBACM_TPU_TORCH_DEVICE; without a card this raises RuntimeError.
    Pass device="cpu" to decode on the CPU. Synthesis
    is the CUDA kernel on a card and its plain torch version on the CPU.

    `devices=[...]` (device.make_mesh, or any list; a device may repeat)
    shards the files over the list instead: `chunk_files` then counts
    files per device, each chunk is cut into one contiguous group per
    device, and every group is decoded on its own device with no
    collectives.

    Buckets files by (level, rows, padded block capacity), then per chunk
    of `chunk_files` files: host scan, copy, synthesis — successive chunks
    pipeline host scan against the copy and the device work.

    Under a torch profiler the call records its spans and counters
    (utils.profiling: `libacm.corpus.*`, `libacm.copy.*`).
    """
    if devices is not None and device is not None:
        raise ValueError("pass device or devices, not both")
    devs = _resolve_devices(device if devices is None else devices)
    if config is not None:
        if config.backend != "auto":
            raise ValueError(f"decode_corpus_device takes backend 'auto' "
                             f"only, not {config.backend!r}")
        force_chans = config.force_chans
        chunk_files = config.chunk_files
        pack = config.pack
    with profiling.call("libacm.corpus.decode", files=len(sources),
                        devices=len(devs)) as root:
        return _decode_corpus_device(sources, devs, force_chans,
                                     chunk_files, pack, root)


def _bucket_by_shape(sources: Sequence[Source], force_chans: int,
                     out: DeviceCorpus
                     ) -> dict[tuple[int, int, int], list[_FileEntry]]:
    """The cheap header pass: files bucketed by shape key. Only a 64-byte
    prefix + the file size are read here; full bytes load per chunk at
    scan time, so ingest host memory is O(chunk), not O(corpus). Files
    that cannot be opened or parsed go to `out` as failed."""
    buckets: dict[tuple[int, int, int], list[_FileEntry]] = {}
    for i, src in enumerate(sources):
        try:
            head, nbytes = _peek_source(src)
        except OSError:
            # per-file isolation covers IO too: an unreadable path yields
            # a FileResult, never kills the batch
            out._add_failed(FileResult(index=i, info=None, pcm=None,
                                       status=int(AcmError.ERR_OPEN)))
            continue
        header = parse_header(BitReader(head))
        if header is None:
            out._add_failed(FileResult(index=i, info=None, pcm=None,
                                       status=int(AcmError.ERR_NOT_ACM)))
            continue
        e = _FileEntry(
            index=i, src=src, header=header, nbytes=nbytes,
            channels=resolve_channels(header.channels, header.wavc_file,
                                      force_chans),
        )
        key = (header.level, header.rows,
               _pad_blocks(header.max_blocks_in(nbytes)))
        buckets.setdefault(key, []).append(e)
    return buckets


def _decode_corpus_device(sources: Sequence[Source],
                          devs: list[torch.device], force_chans: int,
                          chunk_files: int | None, pack: bool,
                          root) -> DeviceCorpus:
    """decode_corpus_device's body, inside the call's root span `root`."""
    n_shards = len(devs)
    t_start = time.perf_counter()
    out = DeviceCorpus(len(sources), devs)

    # 1. cheap header pass → buckets keyed by shape
    with profiling.span("libacm.corpus.headers"):
        buckets = _bucket_by_shape(sources, force_chans, out)

    use_cols_wire = pack
    if use_cols_wire:
        from ..scan import native as _native

        use_cols_wire = _native.available()

    # 2. the chunks of every bucket, in order
    chunks = []
    for (level, rows, nb), entries in buckets.items():
        cols = 1 << level
        per_file = max(1, nb * rows * cols)
        if chunk_files is not None:
            step = max(1, chunk_files) * n_shards
        else:
            # auto: ~16M samples per dispatch (per device), 8..256 files
            step = min(256, max(8, -(-16_000_000 // per_file))) * n_shards
        if use_cols_wire:
            # the JAX reference caps a chunk's per-shard payload stream
            # below 2^31 bits (128M samples * 16 bits); same chunks here
            step = min(step, max(n_shards, ((1 << 27) // per_file) * n_shards))
        for lo in range(0, len(entries), step):
            shards = [(g, d) for g, d in zip(
                _shard(entries[lo : lo + step], n_shards), devs) if g]
            chunks.append((level, rows, nb, shards))

    if not use_cols_wire:
        for level, rows, nb, shards in chunks:
            for g, d in shards:
                out._add_bucket(_dispatch_dense(
                    g, level, rows, nb, 2 * (1 << level) - 2, d, pack=pack))
    else:
        _pipeline_cols_wire(chunks, out, root)

    s = out.summary
    for b in out._buckets:
        block_len = b.rows << b.level
        for e in b.entries:
            if e.open_failed:
                s.n_failed += 1
                continue
            s.samples += e.n_good * block_len
            if e.first_err in (0, ACM_EXPECTED_EOF):
                s.n_ok += 1
            else:
                s.n_partial += 1
    s.n_failed += len(out._failed)
    s.wall_s = time.perf_counter() - t_start
    logger.debug("corpus decode: %s", s.as_dict())
    return out


def _pipeline_cols_wire(chunks: list, out: DeviceCorpus, root) -> None:
    """Scan → copy → dispatch of the chunks, in their order, into `out`.

    The scanner pool scans every device group of a chunk as its own task,
    up to `workers + 6` chunks ahead of the calling thread, which waits
    for each chunk's scans in order (`libacm.corpus.scan.wait`, the
    summary's scan_s) and hands the chunk to the one submitter thread: at
    most six dispatches in flight, and the buckets reach `out` in chunk
    order."""
    workers, scanner = _scanner()
    profiling.count("libacm.corpus.scan.workers", workers)
    call = _ScanCall()
    submitter = ThreadPoolExecutor(max_workers=1)
    ahead: collections.deque = collections.deque()  # (chunk, scan futures)
    todo = iter(chunks)
    current = ()  # scan futures of the chunk taken but not dispatched
    pending: list = []
    n_collected = 0
    n_overlapped = 0

    def scan_next() -> None:
        c = next(todo, None)
        if c is not None:
            level, rows, nb, shards = c
            ahead.append((c, [scanner.submit(_scan_group, g, level, rows,
                                             nb, d, root, call)
                              for g, d in shards]))

    def collect(fut) -> None:
        with profiling.span("libacm.corpus.wait"):
            done = fut.result()
        for b in done:
            out._add_bucket(b)

    try:
        for _ in range(workers + 6):
            scan_next()
        while ahead:
            (level, rows, nb, shards), current = ahead.popleft()
            t0 = time.perf_counter()
            with profiling.span("libacm.corpus.scan.wait",
                                chunk=len(pending)) as sp:
                scanned = [f.result() for f in current]
            # while recording, the wait spans are the clock
            out.summary.scan_s += (sp.ns / 1e9 if root.recording
                                   else time.perf_counter() - t0)
            n_overlapped += sum(o for _, _, o in scanned)
            # bound in-flight dispatches: caps host memory at O(few
            # chunks) of wire arrays and lets pooled buffers recycle
            while len(pending) - n_collected >= 6:
                collect(pending[n_collected])
                n_collected += 1
            groups = [(g, arrays, w, d)
                      for (g, d), (arrays, w, _) in zip(shards, scanned)]
            fut = submitter.submit(_dispatch_cols_wire, groups, level, rows,
                                   nb, root, len(pending))
            for _, _, w, _ in groups:
                w.fut = fut
            current = ()
            pending.append(fut)
            scan_next()
        for fut in pending[n_collected:]:
            collect(fut)
    except BaseException:
        # a failed scan, wait or submit must not leave holds pinned (the
        # pool keeps busy buffers unconditionally): drop the queued
        # scans, let the running ones end, release what they hold
        left = list(current) + [f for _, fs in ahead for f in fs]
        for f in left:
            f.cancel()
        wait(left)
        for f in left:
            if not f.cancelled() and f.exception() is None:
                f.result()[1].fut = None
        raise
    finally:
        submitter.shutdown(wait=False)
        profiling.count("libacm.corpus.scan.overlapped", n_overlapped)


def _dispatch_dense(chunk, level, rows, nb, wlen, device: torch.device,
                    pack: bool) -> _BucketOut:
    """Dense-tensor path (pack=False, or no native scanner): per-file scan
    into [B, nb, rows, cols], optionally per-block width-class packing for
    the copy, then synthesis on the device."""
    from ..ops.synth_torch import synth_pcm_packed, synthesize

    cols = 1 << level
    b = len(chunk)
    k = np.zeros((b, nb, rows, cols), dtype=np.int16)
    vals = np.zeros((b, nb), dtype=np.int32)
    for j, e in enumerate(chunk):
        data = e.load_data()
        if e.open_failed:
            continue  # row stays zero; _finalize reports ERR_OPEN
        scan = scan_bytes(data)
        e.n_good = scan.n_blocks
        _, e.first_err = _n_good(scan.events)
        e.events = scan.events
        if scan.n_exceptions:
            _host_decode_fallback(e, data)  # stale-amp-table: exact path
        n = min(e.n_good, nb)
        if n:
            k[j, :n] = scan.k[:n]
            vals[j, :n] = scan.val[:n].astype(np.int32)
    wrap0 = torch.zeros((b, wlen), dtype=torch.int32, device=device)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    if pack:
        # pack coefficients for the copy; unpack happens on the device
        # (class counts padded to multiples of 64 blocks)
        from ..ops.packing import class_counts, pack_blocks

        kflat = k.reshape(b * nb, rows, cols)
        pads = tuple(_round_up(c, 64) for c in class_counts(kflat))
        pk = pack_blocks(kflat, pad_to=pads)
        pcm, _ = synth_pcm_packed(
            put(pk.p4), put(pk.p8), put(pk.p16),
            put(pk.idx4), put(pk.idx8), put(pk.idx16),
            put(vals), wrap0,
            level=level, rows=rows, batch=b, nb=nb, backend="cuda",
        )
    else:
        pcm, _ = synthesize(put(k), put(vals), wrap0, level=level, rows=rows,
                            backend="cuda")
    return _BucketOut(level=level, rows=rows, entries=chunk, pcm=pcm)


#: windowed stream scan statuses (mirror _scan.cpp)
_EXPECTED_EOF = -99
_NEED_MORE_DATA = -98


class _StreamReader:
    """Incremental byte feeder for decode_stream_device: wraps a path,
    bytes, or read()-only object; never holds more than what the caller's
    window needs (paths are NOT slurped)."""

    def __init__(self, src):
        self._close = None
        if isinstance(src, (bytes, bytearray)):
            import io as _io

            self._f = _io.BytesIO(src)
        elif hasattr(src, "read"):
            self._f = src
        else:
            self._f = open(src, "rb")
            self._close = self._f.close

    def read(self, n: int) -> bytes:
        return self._f.read(n) or b""

    def close(self) -> None:
        if self._close is not None:
            self._close()


class _PrefixedReader:
    """read()-only view that serves buffered head bytes first."""

    def __init__(self, pre: bytearray, rd: "_StreamReader"):
        self._pre, self._rd = bytearray(pre), rd

    def read(self, n: int) -> bytes:
        if self._pre:
            out = bytes(self._pre[:n])
            del self._pre[:n]
            return out
        return self._rd.read(n)


def _stream_data_start(header: AcmHeader) -> int:
    from ..format import ACM_HEADER_LEN, WAVC_HEADER_LEN

    return ACM_HEADER_LEN + (WAVC_HEADER_LEN if header.wavc_file else 0)


def _stream_wire_chunks(reader: "_StreamReader", e: _FileEntry, W: int,
                        state: dict):
    """Windowed packed scan of one stream, yielding full wire chunks.

    Each yielded chunk is (cls [W, stride], pay4, pay8, pay16, wid4, wid8,
    wid16, vals [W]) covering W committed blocks (the final chunk may
    cover fewer; its tail rows are zero). Host residency: the byte window
    + one chunk's wire. Sets state["oor"] (stale-amp-table: caller must
    fall back) and appends per-window event arrays to state["events"];
    e.n_good tracks committed blocks. The scan's first pass over data the
    window didn't fully cover is rolled back and retried with a grown
    window (NEED_MORE_DATA), so re-emission stays clean.
    """
    from ..scan import native as _native

    hdr = e.header
    level, rows, cols = hdr.level, hdr.rows, hdr.cols
    buf = bytearray()
    bit = 0
    eof = False
    # The reference stops reading once total_values words are delivered
    # (acm_read clamp, decode.c:853-854) — it never attempts the next
    # block, so bits past the declared block count must not contribute
    # events/status (the one-shot corpus scan bounds max_blocks by
    # header.n_blocks the same way).
    remaining = hdr.n_blocks
    # initial prefetch guess: ~4 wire bits/sample + block/column headers
    need = max(1 << 16, (W * (rows * cols * 4 + 20 + 5 * cols)) // 8)
    bufs = _native.CorpusScanBuffers()
    while True:
        while not eof and len(buf) < need:
            got = reader.read(max(need - len(buf), 1 << 16))
            if not got:
                eof = True
                break
            buf += got
        if not bufs.fits(len(buf)):
            bufs = _native.CorpusScanBuffers(
                max_file_bytes=len(buf) + (1 << 16))
        c4, c8, c16, cw = _native.pay_stream_caps(W * cols, rows)
        cls = np.zeros((W, (cols + 3) // 4), dtype=np.uint8)
        pwr = np.zeros(W, dtype=np.uint8)
        vals = np.zeros(W, dtype=np.uint16)
        pay4 = np.zeros(c4, dtype=np.uint8)
        pay8 = np.zeros(c8, dtype=np.uint8)
        pay16 = np.zeros(c16, dtype=np.uint8)
        wid4 = np.zeros(cw, dtype=np.uint8)
        wid8 = np.zeros(cw, dtype=np.uint8)
        wid16 = np.zeros(cw, dtype=np.uint8)
        ng, _err, ncol, bits, oor, events = _native.scan_corpus_into(
            memoryview(buf), hdr, cls, pwr, vals, pay4, pay8, pay16,
            wid4, wid8, wid16, bufs, start_bit=bit, final=eof,
            max_blocks=min(W, remaining),
        )
        status = int(bufs.meta[2])
        resume = int(bufs.meta[10])
        if oor:
            state["oor"] = True
            return
        if status == _NEED_MORE_DATA and not eof:
            # window ran dry mid-scan: grow it and rescan from the window
            # start (fresh wire buffers per attempt: re-emission is clean)
            need = int(need * 1.7) + (1 << 16)
            continue
        state["events"].append(events)
        if ng > 0:
            e.n_good += ng
            remaining -= ng

            def _sl(a, used_bytes):
                # Next-power-of-two slices, as the JAX package cuts them
                # (there for its compile cache, which torch does not
                # have). Kept so that the wire chunks stay byte-equal to
                # the reference's, which a test holds; cutting to the
                # used length would copy up to half the bytes less.
                n = max(256, 1 << (used_bytes + 1).bit_length())
                return a[: min(n, len(a) - (len(a) & 1))]

            yield (cls, _sl(pay4, -(-bits[0] // 8)),
                   _sl(pay8, -(-bits[1] // 8)),
                   _sl(pay16, -(-bits[2] // 8)),
                   _sl(wid4, -(-ncol[0] // 2)),
                   _sl(wid8, -(-ncol[1] // 2)),
                   _sl(wid16, -(-ncol[2] // 2)), vals)
        if status == _EXPECTED_EOF or remaining <= 0:
            return
        # full window committed (status 0): drop consumed bytes and keep
        # scanning — the buffer may still hold undecoded blocks even at
        # reader EOF; the final=True pass ends it with EXPECTED_EOF.
        # (Rebuild instead of `del buf[:drop]`: the ctypes call keeps a
        # cyclic export of the old buffer alive until gc, which would
        # make an in-place resize raise BufferError.)
        drop = resume // 8
        buf = bytearray(memoryview(buf)[drop:])
        bit = resume - 8 * drop


def decode_stream_device(
    source,
    *,
    device: Device = None,
    devices: Sequence[Device] | None = None,
    force_chans: int = 0,
    window_blocks: int | None = None,
):
    """Decode ONE stream on the device, its carry kept there; over a
    device list, with its block axis cut across the list.

    Returns (pcm, FileResult with pcm=None carrying status and filler
    metadata). On one device `pcm` is an int16 tensor [nb, block_len].
    Over several devices it is a list of int16 tensors [span, block_len]
    in block order, tensor i on devices[i % len(devices)], as the spans
    lie: nothing is gathered, `torch.cat([p.to(dev) for p in pcm])` does
    that where a caller wants it. Blocks past the stream's committed
    count (the zero tail rows of the last window) hold no PCM of the
    stream.

    This is the SAME pipeline as the corpus path: windowed native packed
    scan → cols-wire chunks → unpack + synthesis on the device, with the
    filterbank carry handed from window to window ON THE DEVICE (it is a
    tensor there from the first window to the last and is never fetched).
    With `window_blocks=W`, host residency is O(byte window + one chunk's
    wire): each wire chunk is dispatched as soon as it is scanned, and
    `source` may be a read()-only object. Default (None): one full-file
    window. `device=None` is the card (device.resolve_device).

    Several devices: W is rounded up to the device count and each window
    is scanned as one span of W / n blocks per device, each span's wire
    copied to and unpacked on its own device. Torch has no compiler to
    insert a halo exchange. For rows >= 2 a span's carry-in is the carry
    the block before it leaves behind, which depends on that block alone
    (ops.synth_torch.carry_of_block): one block of k and one val are
    copied from the device before, so no span waits for the synthesis of
    the span before it. For rows == 1 the carry depends on every earlier
    block, and at level 0 it has no words: there the final carry is
    chained span to span in order. The last span's final carry is the
    next window's first carry.

    Stale-amp-table streams (hostile input) fall back to the exact host
    decoder (O(file)): in full-file mode the bytes are already in hand
    (read()-only sources included), while the WINDOWED scan must re-read
    the stream — from a consumed read()-only source that is impossible,
    and a ValueError says so (AcmStream's windowed mode handles hostile
    pipes exactly instead).
    """
    from ..ops.synth_torch import synthesize, unpack_cols_blob
    from ..scan import native as _native

    if devices is not None and device is not None:
        raise ValueError("pass device or devices, not both")
    devs = _resolve_devices(device if devices is None else devices)
    n_shards = len(devs)
    use_native = _native.available()
    full_data: bytes | None = None  # full-file mode keeps the bytes in hand
    if not use_native or window_blocks is None:
        # one full-file window (and the only mode without the native
        # scanner, which then routes through the exact oracle fallback)
        try:
            if hasattr(source, "read") and not isinstance(
                    source, (bytes, bytearray)):
                data = bytes(source.read())  # fresh read()-only object
            else:
                data = _read_source(source)
        except OSError as exc:
            raise AcmException(AcmError.ERR_OPEN) from exc
        header = parse_header(BitReader(data))
        if header is None:
            raise AcmException(AcmError.ERR_NOT_ACM)
        full_data = data
        reader = _StreamReader(data[_stream_data_start(header):])
        # Implicit window cap. The JAX unpack computes bit offsets in
        # int32, so one window's payload must stay under 2^31 bits there;
        # the port's offsets are int64 and need no cap, but the same
        # windows keep the two packages chunking a huge file alike.
        W = max(min(header.max_blocks_in(len(data)),
                    (1 << 27) // max(header.block_len, 1) + 1), 1)
        nbytes = len(data)
    else:
        try:
            reader0 = _StreamReader(source)
        except OSError as exc:
            raise AcmException(AcmError.ERR_OPEN) from exc
        head = bytearray()
        while len(head) < 64:
            got = reader0.read(1 << 16)
            if not got:
                break
            head += got
        header = parse_header(BitReader(bytes(head)))
        if header is None:
            reader0.close()
            raise AcmException(AcmError.ERR_NOT_ACM)
        reader = _StreamReader(
            _PrefixedReader(head[_stream_data_start(header):], reader0))
        W = window_blocks
        nbytes = 0  # unknown; the windowed scan discovers the stream end

    e = _FileEntry(
        index=0, src=source, header=header, nbytes=nbytes,
        channels=resolve_channels(header.channels, header.wavc_file,
                                  force_chans),
    )
    level, rows, bl = header.level, header.rows, header.block_len
    W = max(_round_up(W, n_shards), n_shards)
    span = W // n_shards
    # the carry of rows >= 2 depends on the last block alone; else chain
    halo = n_shards > 1 and rows >= 2 and level >= 1

    state = {"oor": not use_native, "events": []}
    parts: list[torch.Tensor] = []
    try:
        if use_native:
            # dispatch each span's wire as it is scanned; the carry goes
            # from span to span and window to window without leaving the
            # devices. The zero carry is made on the device that takes it.
            wrapf = torch.zeros((1, header.wrapbuf_len), dtype=torch.int32,
                                device=devs[0])
            k = vals = None
            for i, wire in enumerate(
                    _stream_wire_chunks(reader, e, span, state)):
                dev = devs[i % n_shards]
                blob, lens = _coalesce_wire(
                    (wire[0][None], *wire[1:7], wire[7][None]))
                prev_k, prev_vals = k, vals
                k, vals, _ = unpack_cols_blob(
                    torch.from_numpy(blob).to(dev), level=level, rows=rows,
                    batch=1, nb=span, lens=lens, has_wrap=False)
                if halo and i % n_shards:
                    # the block before this span, synthesized alone from
                    # a zero carry on this device: its final carry
                    _, carry = synthesize(
                        prev_k[:, -1:].to(dev), prev_vals[:, -1:].to(dev),
                        torch.zeros_like(wrapf, device=dev), level=level,
                        rows=rows, backend="cuda")
                else:
                    carry = wrapf.to(dev)
                pcm_c, wrapf = synthesize(k, vals, carry, level=level,
                                          rows=rows, backend="cuda")
                parts.append(pcm_c.reshape(span, bl))
    finally:
        reader.close()

    e.events = (np.concatenate(state["events"]) if state["events"]
                else np.zeros(0, dtype=np.int16))
    if state["oor"]:
        # stale-amp-table stream (hostile input) or no native scanner:
        # only the exact host decode reproduces the reference — which
        # needs the stream from the start (the dirty-table values depend
        # on every prior block). Full-file mode already holds the whole
        # stream; only the windowed scan must re-read the source.
        data = full_data if full_data is not None else _reread_source(source)
        if data is None:
            raise ValueError(
                "hostile (stale-amp-table) stream from an unseekable "
                "source: the exact decode must re-read the stream; pass "
                "bytes/a path/a seekable object, or use "
                "AcmStream(window_blocks=N), which reproduces the "
                "stale-table semantics on the host in O(window) memory")
        _host_decode_fallback(e, data)
        per = -(-max(e.n_good, 1) // n_shards)
        full = np.zeros(per * n_shards * bl, dtype=np.int16)
        n = min(len(e.host_pcm), len(full))
        full[:n] = e.host_pcm[:n]
        full = full.reshape(n_shards, per, bl)
        parts = [torch.from_numpy(full[s]).to(devs[s])
                 for s in range(n_shards)]
    else:
        _, e.first_err = _n_good(e.events)
        if not parts:
            parts = [torch.zeros((1, bl), dtype=torch.int16, device=devs[0])]
    meta = _finalize(e, np.zeros(0, np.int16), bl)
    meta.pcm = None
    if n_shards > 1:
        return parts, meta
    return (torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]), meta


#: decode_corpus_host slices the corpus into native batches of at most this
#: many files / input bytes, so host residency stays O(batch) of raw bytes
_HOST_BATCH_FILES = 256
_HOST_BATCH_BYTES = 128 << 20


def decode_corpus_host(
    sources: Sequence[Source],
    *,
    force_chans: int = 0,
    workers: int = 1,
) -> list[FileResult]:
    """Pure-host corpus decode: fused C++ scan+synth, batched native calls.

    The host-output fast path: when the consumer needs PCM bytes on the
    host, synthesizing on the device and fetching back wastes the link.
    Files cross the ctypes boundary in batches (`acm_decode_corpus_host_batch`)
    — one GIL-released native sweep per ~256 files. Raw input bytes are
    held O(batch), not O(corpus).

    `workers > 1` decodes batches concurrently: the native call releases
    the GIL and every scratch/PCM pool is thread-local. Results are
    index-ordered either way.
    """
    from ..scan import native as _native

    results: list[FileResult | None] = [None] * len(sources)

    def _run_batch(lo: int, hi: int) -> None:
        # read + header-parse this slice; failures resolve immediately
        blobs: list[bytes] = []
        headers = []
        idxs: list[int] = []
        for i in range(lo, hi):
            try:
                data = _read_source(sources[i])
            except OSError:
                results[i] = FileResult(index=i, info=None, pcm=None,
                                        status=int(AcmError.ERR_OPEN))
                continue
            header = parse_header(BitReader(data))
            if header is None:
                results[i] = FileResult(index=i, info=None, pcm=None,
                                        status=int(AcmError.ERR_NOT_ACM))
                continue
            blobs.append(data)
            headers.append(header)
            idxs.append(i)
        for s in range(0, len(idxs), _HOST_BATCH_FILES):
            # secondary split on input bytes so a batch of huge files
            # doesn't pin the whole slice's raw bytes at once
            t = s
            while t < min(s + _HOST_BATCH_FILES, len(idxs)):
                u = t
                nbytes = 0
                while (u < min(s + _HOST_BATCH_FILES, len(idxs))
                       and (u == t or nbytes + len(blobs[u])
                            <= _HOST_BATCH_BYTES)):
                    nbytes += len(blobs[u])
                    u += 1
                batch = _native.decode_corpus_host_batch(blobs[t:u],
                                                         headers[t:u])
                for off, bf in enumerate(batch):
                    i = idxs[t + off]
                    header = headers[t + off]
                    e = _FileEntry(
                        index=i, src=sources[i], header=header,
                        nbytes=len(blobs[t + off]),
                        channels=resolve_channels(header.channels,
                                                  header.wavc_file,
                                                  force_chans),
                    )
                    if bf.overflowed:
                        # heavily corrupt stream: its attempt list blew
                        # the batch's event slot — exact solo rescan
                        _apply_host_decode(
                            e, _native.decode_host(blobs[t + off], header))
                    else:
                        e.n_good = bf.n_good
                        e.first_err = bf.first_err
                        e.events = bf.events
                        e.host_pcm = bf.pcm
                    results[i] = _finalize(e, e.host_pcm, header.block_len)
                    blobs[t + off] = b""  # release raw bytes eagerly
                t = u

    if workers <= 1 or len(sources) <= 1:
        _run_batch(0, len(sources))
    else:
        step = -(-len(sources) // workers)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(lambda lo: _run_batch(lo, min(lo + step,
                                                      len(sources))),
                        range(0, len(sources), step)))
    return results  # type: ignore[return-value]


def decode_corpus(
    sources: Sequence[Source],
    *,
    device: Device = None,
    devices: Sequence[Device] | None = None,
    force_chans: int = 0,
    backend: str = "auto",
    chunk_files: int | None = None,
    pack: bool = True,
    config: CorpusConfig | None = None,
) -> list[FileResult]:
    """Decode a corpus of ACM/WAVC files; PCM lands on the host per file.

    backend="auto" (default) decodes on `device` and fetches: `device=None`
    is the card (or $LIBACM_TPU_TORCH_DEVICE), and without one this raises
    RuntimeError. With
    device="cpu" it takes the fused native host decoder when that is
    built. backend="host" asks for the native host decoder and requires it.
    `devices=[...]` implies device decode, sharded over the list (see
    decode_corpus_device), whatever the devices are.
    """
    host_workers = 1
    if config is not None:
        # a config wins over the keyword arguments entirely, exactly as in
        # decode_corpus_device
        force_chans = config.force_chans
        chunk_files = config.chunk_files
        pack = config.pack
        backend = config.backend
        host_workers = config.host_workers
    if backend not in ("auto", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    if devices is not None:
        if backend == "host":
            raise ValueError("backend 'host' decodes on the CPU and takes "
                             "no device list")
        return decode_corpus_device(
            sources, device=device, devices=devices,
            force_chans=force_chans, chunk_files=chunk_files, pack=pack,
            config=config,
        ).to_results()
    if backend == "host":
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError("backend 'host' decodes on the CPU, not on "
                             f"{device!r}")
        dev = torch.device("cpu")
    else:
        dev = _resolve_device(device)
    if dev.type == "cpu":
        from ..scan import native as _native

        if _native.available():
            return decode_corpus_host(sources, force_chans=force_chans,
                                      workers=host_workers)
        if backend == "host":
            raise RuntimeError("native host decoder unavailable")
    return decode_corpus_device(
        sources, device=dev, force_chans=force_chans,
        chunk_files=chunk_files, pack=pack, config=config,
    ).to_results()
