"""Streaming decode API with reference-compatible semantics.

Python equivalent of the reference's L3/L4 surface
(the C reference's `src/decode.c:758-893`, `util.c:93-277`): open / read /
read_loop / seek / info / telemetry / close, with the same observable
behavior — per-call block chunking, total_values clamp, channel-multiple
clamp, force_chans resolution, EOF quirks, error taxonomy, the
return-reached-position seek contract, and raw_tell byte accounting.

Architecture: instead of the reference's lazy per-block mutable pipeline,
a stream scans its bitstream once into dense coefficient tensors (host,
serial — oracle or C++ scanner) and synthesizes PCM on demand in one
launch of the CUDA synthesis kernel on the card (ops.synth_torch.
decode_scan_result; its plain torch version for device="cpu", the native
host synth for synth_backend="host"). The read/seek state machine then
just walks a decoded int16 array while reproducing the C call-by-call
arithmetic. This module is the port of libacm_tpu/stream.py; it differs
only at those device seams (_ensure_pcm, _reseed_amp_table, `device`).

Error semantics match the reference exactly, including its
keep-going-after-error behavior: every read with no block ready consumes
one decode *attempt* (scan event); an attempt that failed with
ERR_CORRUPT / ERR_UNEXPECTED_EOF surfaces that error for that call, and the
next read continues from the bit position where the failed attempt stopped
— exactly what the C's next `decode_block` would do (decode.c:840-846).
"""

from __future__ import annotations

import array
import dataclasses
import json
import os
from typing import Union

import numpy as np

from . import io as acmio
from . import scan as scanmod
from .format import (
    ACM_EXPECTED_EOF,
    ACM_HEADER_LEN,
    ACM_ID,
    ACM_WORD,
    ACMInfo,
    AcmError,
    AcmException,
    acm_strerror,
    resolve_channels,
)
from .scan.oracle import BitReader, ScanResult, parse_header

Source = Union[str, os.PathLike, bytes, bytearray, acmio.AcmIO]


@dataclasses.dataclass(frozen=True)
class DecodeState:
    """Serializable resume point of a stream (SURVEY §5 checkpoint/resume).

    The reference has no checkpointing — its analog is backward seek, a
    full reset + O(position) re-decode (util.c:214-253). Because this
    framework's heavy state (the scan + synthesized PCM) is a pure cache
    derived from the source bytes, the complete resumable state is just the
    read-cursor machine below; restoring is O(1) given the same source.
    The fields mirror the reference's live state (stream_pos/block_pos/
    block_ready, libacm.h:80-99) plus this design's event cursor.
    """

    stream_pos: int
    block_pos: int
    block_ready: bool
    event_idx: int
    cur_block: int
    blocks_popped: int
    end_attempted: bool
    post_seek: bool
    force_channels: int  # effective channel count (resolution result)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "DecodeState":
        return cls(**json.loads(s))


class _Window:
    """Bounded-memory incremental decode over an `AcmIO` source.

    The reference decodes any stream in O(64 KiB + block) memory from
    arbitrary IO (decode.c:29, 41-67); this is that capability on the
    fused native pipeline: a sliding byte window plus up to
    `window_blocks` decoded blocks resident, with the filterbank carry
    and stale-amp-table state threaded across windows
    (scan.native.decode_host_window). Byte-identical to the slurped
    full-file decode (tests/test_stream_windowed.py).
    """

    CHUNK = 64 * 1024  # source read granularity (= the C's ACM_BUFLEN)

    def __init__(self, stream: "AcmStream", window_blocks: int,
                 head: bytes, head_eof: bool):
        from .scan import native as _native

        self._native = _native
        self.s = stream
        self.h = stream._header
        self.wb = max(1, window_blocks)
        self.cap = self.h.n_blocks
        self.buf = bytearray(head)
        self.base = 0  # absolute file offset of buf[0]
        self.src_eof = head_eof
        self.file_len: int | None = len(head) if head_eof else None
        self.resume = 8 * self.h.data_start  # absolute next-attempt bit
        self.wrap = np.zeros(max(self.h.wrapbuf_len, 1), dtype=np.uint32)
        self.table = _native.AmpTable()
        #: per-attempt amp header fields, append-only ACROSS passes (the
        #: bit content is identical every pass, so attempt i's (pwr, val)
        #: never changes; reset() folds these to rebuild the table).
        #: Compact typed arrays: 3 bytes/attempt, the one window-mode
        #: structure that grows with stream length.
        self.att_pwr = array.array("B")
        self.att_val = array.array("H")
        #: amp table folded over completed passes (reset() folds one more
        #: pass each backward seek — O(attempts/seek), not O(history))
        self._folded = _native.AmpTable()
        self._folded_passes = 0
        self._clear_progress()

    def _clear_progress(self) -> None:
        """Decode-progress state shared by open and backward-seek reset."""
        self.events: list[int] = []
        self.ev_bits: list[int] = []  # absolute consumed-bit per event
        self.blocks = {}  # committed idx -> int16 words
        self._floor = 0
        self.committed = 0
        self.terminal = False  # no further events will ever be produced
        self.end_bits: int | None = None  # consumed bits at terminal

    def _fill(self) -> None:
        """One decode/IO round; guaranteed to make progress."""
        if self.terminal:
            return
        if self.committed >= self.cap:
            self.terminal = True
            self.end_bits = self.resume
            return
        hd = self._native.decode_host_window(
            self.buf, self.h.level, self.h.rows,  # zero-copy view
            self.resume - 8 * self.base, self.wrap, self.table,
            max_blocks=min(self.wb, self.cap - self.committed),
            final=self.src_eof, wavc_file=self.h.wavc_file,
        )
        bl = self.h.block_len
        for j in range(hd.n_good):
            self.blocks[self.committed + j] = hd.pcm[j * bl : (j + 1) * bl].copy()
        prev = len(self.events)
        self.committed += hd.n_good
        self.events.extend(int(x) for x in hd.events)
        self.ev_bits.extend(8 * self.base + int(x) for x in hd.ev_bits)
        for j in range(len(self.att_pwr) - prev, len(hd.events)):
            self.att_pwr.append(int(hd.ev_pwr[j]))
            self.att_val.append(int(hd.ev_val[j]))
        if hd.term_att is not None and len(self.att_pwr) == len(self.events):
            # terminal attempt: read pwr/val (updating the amp table) but
            # hit clean EOF before producing an event — record it at
            # attempt index len(events) so a post-drain seek folds it
            self.att_pwr.append(hd.term_att[0])
            self.att_val.append(hd.term_att[1])
        self.resume = 8 * self.base + hd.end_bit
        drop = min((self.resume >> 3) - self.base, len(self.buf))
        del self.buf[: drop]
        self.base += drop
        if hd.status == self._native.NEED_MORE_DATA:
            if self.committed >= self.cap:
                self.terminal = True
                self.end_bits = self.resume
                return
            chunk = self.s._src.read(self.CHUNK)
            if not chunk:
                self.src_eof = True
                self.file_len = self.base + len(self.buf)
            else:
                self.buf += chunk
            return
        if hd.status == ACM_EXPECTED_EOF or self.committed >= self.cap:
            self.terminal = True
            self.end_bits = self.resume

    def ensure_event(self, idx: int) -> int | None:
        """Event for attempt `idx`, decoding forward as needed (None: EOF)."""
        while idx >= len(self.events) and not self.terminal:
            self._fill()
        return self.events[idx] if idx < len(self.events) else None

    def block_words(self, abs_idx: int) -> np.ndarray:
        return self.blocks[abs_idx]

    def drop_below(self, abs_idx: int) -> None:
        while self._floor < abs_idx:
            self.blocks.pop(self._floor, None)
            self._floor += 1

    def resident_bytes(self) -> int:
        """Window memory footprint (observability / boundedness tests)."""
        return len(self.buf) + sum(b.nbytes for b in self.blocks.values())

    def ensure_extent(self, abs_bytes: int) -> None:
        """Pull source bytes until the file provably reaches `abs_bytes`
        or EOF is found (raw_tell needs to know whether the strict
        reader's final reload would be truncated; the C reads 64 KiB
        ahead anyway, decode.c:41-67)."""
        while self.file_len is None and self.base + len(self.buf) < abs_bytes:
            chunk = self.s._src.read(self.CHUNK)
            if not chunk:
                self.src_eof = True
                self.file_len = self.base + len(self.buf)
                return
            self.buf += chunk

    def reset(self) -> None:
        """Backward-seek reset (util.c:230-241): restart at data_start."""
        self.s._src.seek(self.h.data_start)
        self.buf = bytearray()
        self.base = self.h.data_start
        self.src_eof = False
        self.resume = 8 * self.h.data_start
        self.wrap[:] = 0
        # The reference's amp table persists across seeks (util.c:230-241
        # zeroes only wrapbuf) — but it reflects only the attempts its
        # reads CONSUMED, while this window may have decoded ahead. Fold
        # each newly completed pass's consumed attempts into the running
        # table (live-diffed vs the compiled reference library in
        # tests/test_ref_live.py and the fuzzer's seek rounds).
        hist = self.s._pass_history
        for upto in hist[self._folded_passes:]:
            for i in range(min(upto, len(self.att_pwr))):
                p = min(self.att_pwr[i], 16)
                self._folded.val[: p + 1] = self.att_val[i]
                self._folded.cov[: p + 1] = 1
        self._folded_passes = len(hist)
        self.table = self._native.AmpTable(val=self._folded.val.copy(),
                                           cov=self._folded.cov.copy())
        self._clear_progress()


class AcmStream:
    """One open ACM/WAVC stream (analog of `ACMStream`, libacm.h:71-100).

    `window_blocks=N` selects bounded-memory streaming: the source is
    consumed incrementally and at most N decoded blocks plus an O(64 KiB)
    byte window stay resident — the reference's streaming-consumer shape
    (decode.c:29, 41-67) — instead of the default whole-file decode.
    Requires the native scanner; without it a ResourceWarning is issued
    and the stream falls back to whole-file decode (the bounded-memory
    contract cannot be met, and pretending otherwise would hide an
    O(file)-RSS surprise from streaming consumers). `has_errors()` is
    unavailable in windowed mode.

    Thread-safety contract — one stream, one thread, like the reference:
    nothing in `ACMStream` is locked and its consumers serialize instead
    (gstreamer runs seeks in the task thread under the object lock,
    plugin-gstreamer.c:505-508,621-651; winamp posts `seek_to` to its
    decode thread, plugin-winamp.c:186-213). The same holds here: all
    reads/seeks on one AcmStream must be serialized by the caller — the
    idiomatic pattern is a seek-request handshake where a control thread
    posts the target and the decode thread performs the seek (exercised
    in tests/test_concurrency.py). Distinct streams are fully
    independent, including the native scanner (per-thread scratch), and
    `RandomAccessCorpus` is internally locked for many-reader serving.

    Synthesis runs on `device` (None: the card, or $LIBACM_TPU_TORCH_DEVICE),
    resolved at the open: without a card the open raises RuntimeError
    (the source is closed first) and no read raises for want of a device.
    synth_backend="host" asks for the native host synth instead, and
    windowed mode is a native host decoder: neither needs a device, and
    both open without one.
    """

    def __init__(self, src: acmio.AcmIO, force_chans: int = 0,
                 synth_backend: str | None = None,
                 window_blocks: int | None = None, device=None):
        self._src = src
        self._closed = False
        self._synth_backend = synth_backend
        self._device = device
        self._win: _Window | None = None

        # data_len: only via an explicit length capability (C: NULL
        # get_length_func ⇒ 0 ⇒ not seekable, util.c:152-155).
        self._data_len = src.length() if hasattr(src, "length") else 0
        self._can_seek = hasattr(src, "seek")

        use_window = False
        if window_blocks is not None:
            from .scan import native as _native

            use_window = _native.available()
            if not use_window:
                import warnings

                warnings.warn(
                    "window_blocks requested but the native scanner is "
                    "unavailable; falling back to whole-file decode "
                    "(O(file) memory, not the bounded-memory contract)",
                    ResourceWarning,
                    stacklevel=2,
                )

        if not use_window and synth_backend != "host":
            from .device import resolve_device

            try:
                self._device = resolve_device(device)
            except RuntimeError:
                self._close_src()
                raise

        if use_window:
            # windowed: read just enough to parse the header (the parse
            # touches <= ~48 bytes; same bits => same result as slurped)
            head = bytearray()
            head_eof = False
            while len(head) < 64:
                chunk = src.read(_Window.CHUNK)
                if not chunk:
                    head_eof = True
                    break
                head += chunk
            self._data = None
            bits = BitReader(bytes(head))
        else:
            self._data = acmio.slurp(src)
            bits = BitReader(self._data)

        header = parse_header(bits)
        if header is None:
            # Any header failure maps to NOT_ACM (decode.c:783-784).
            self._close_src()
            raise AcmException(AcmError.ERR_NOT_ACM)
        self._header = header
        self._raw_tell0 = bits.loaded_bytes
        if use_window:
            self._win = _Window(self, window_blocks, bytes(head), head_eof)

        self.info = ACMInfo(
            channels=resolve_channels(header.channels, header.wavc_file, force_chans),
            rate=header.rate,
            acm_id=ACM_ID,
            acm_version=1,
            acm_channels=header.channels,
            acm_level=header.level,
            acm_cols=header.cols,
            acm_rows=header.rows,
        )
        self.total_values = header.total_values
        self.wavc_file = header.wavc_file

        # read-state machine (mirrors stream_pos/block_pos/block_ready)
        self._stream_pos = 0
        self._block_pos = 0
        self._block_ready = False
        self._event_idx = 0  # next scan event (decode attempt) to consume
        self._cur_block = 0  # pcm index of the ready block
        self._blocks_popped = 0
        self._end_attempted = False  # a decode attempt hit terminal EOF
        self._post_seek = False  # raw_tell counts from data_start after reset

        # lazy heavyweight state
        self._scan: ScanResult | None = None
        self._pcm: np.ndarray | None = None  # int16 words for scanned blocks
        self._seek_raw_tell: np.ndarray | None = None
        self._clean_until: int | None = None  # events[:clean_until] are all 0
        #: attempts consumed by each completed decode pass (a backward seek
        #: ends a pass) — determines the reference's persistent amp-table
        #: state for stale-table streams (see _reseed_amp_table)
        self._pass_history: list[int] = []
        self._att_scan: ScanResult | None = None  # oracle per-attempt scan

    # -- lifecycle ---------------------------------------------------------

    def _close_src(self) -> None:
        if hasattr(self._src, "close"):
            try:
                self._src.close()
            except Exception:
                pass

    def close(self) -> None:
        """acm_close (decode.c:878-893). Idempotent."""
        if not self._closed:
            self._close_src()
            self._closed = True

    def __enter__(self) -> "AcmStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- front/back-end plumbing ------------------------------------------

    def _ensure_scan(self) -> ScanResult:
        assert self._win is None, "windowed mode never builds a full scan"
        if self._scan is None:
            self._scan = scanmod.scan_bytes(self._data,
                                            self._header.n_blocks)
        return self._scan

    def _ensure_pcm(self) -> np.ndarray:
        if self._pcm is None:
            from .ops.synth_torch import decode_scan_result

            self._pcm = decode_scan_result(
                self._ensure_scan(), backend=self._synth_backend,
                device=self._device,
            )
        return self._pcm

    # -- core read state machine (acm_read, decode.c:826-876) -------------

    def _read_core(self, numbytes: int, simulate: bool,
                   bigendianp: int, wordlen: int, sgned: int):
        """Returns bytes (possibly empty) or a negative error code."""
        if wordlen != 2:
            return int(AcmError.ERR_BADFMT)
        numwords = numbytes // 2

        if self._stream_pos >= self.total_values:
            return b""

        if not self._block_ready:
            if self._win is not None:
                ev_opt = self._win.ensure_event(self._event_idx)
                if ev_opt is None:
                    self._end_attempted = True
                    return b""
                ev = ev_opt
            else:
                scan = self._ensure_scan()
                if self._event_idx >= len(scan.events):
                    # terminal: EXPECTED_EOF or block cap → EOF
                    # (decode.c:842-843)
                    self._end_attempted = True
                    return b""
                ev = int(scan.events[self._event_idx])
            self._event_idx += 1
            if ev != 0:
                # this attempt failed; the next read keeps going from the
                # failed attempt's bit position, like the reference
                return ev
            self._cur_block = self._blocks_popped
            self._blocks_popped += 1
            self._block_ready = True
            self._block_pos = 0

        h = self._header
        avail = h.block_len - self._block_pos
        numwords = min(numwords, avail)
        numwords = min(numwords, self.total_values - self._stream_pos)
        if self.info.channels > 1:
            numwords -= numwords % self.info.channels

        if simulate:
            out: bytes | int = numwords * wordlen
        elif self._win is not None:
            words = self._win.block_words(self._cur_block)
            out = _format_samples(
                words[self._block_pos : self._block_pos + numwords],
                bigendianp, sgned)
        else:
            pcm = self._ensure_pcm()
            start = self._cur_block * h.block_len + self._block_pos
            out = _format_samples(pcm[start : start + numwords], bigendianp, sgned)

        self._stream_pos += numwords
        self._block_pos += numwords
        if self._block_pos == h.block_len:
            self._block_ready = False
            self._cur_block += 1
            if self._win is not None:
                self._win.drop_below(self._blocks_popped)
        return out

    def _ensure_clean_until(self) -> int:
        """Index of the first failed decode attempt (len(events) if none)."""
        if self._clean_until is None:
            ev = self._ensure_scan().events
            nz = np.flatnonzero(ev != 0)
            self._clean_until = int(nz[0]) if len(nz) else len(ev)
        return self._clean_until

    def has_errors(self) -> bool:
        """True if any decode attempt in the stream failed.

        For a clean stream, read chunking is unobservable (errors are the
        only thing acm_read_loop's partial-data-wins rule can swallow or
        surface depending on chunk boundaries) — consumers like the CLI may
        then read in large chunks without changing a single output byte.
        Unavailable in windowed mode (would force a full-stream decode).
        """
        if self._win is not None:
            raise RuntimeError("has_errors() requires full-file mode")
        return self._ensure_clean_until() < len(self._ensure_scan().events)

    def _bulk_read_win(self, max_blocks: int, bigendianp: int, sgned: int):
        """Windowed-mode analog of _bulk_read: copy up to one window of
        whole clean blocks (never decodes further ahead than the window,
        keeping residency bounded)."""
        w = self._win
        h = self._header
        bl = h.block_len
        lim = min(max_blocks, w.wb,
                  (self.total_values - self._stream_pos) // bl)
        m = 0
        while m < lim:
            ev = w.ensure_event(self._event_idx + m)
            if ev is None or ev != 0:
                break
            m += 1
        if m <= 0:
            return None
        parts = [w.block_words(self._blocks_popped + j) for j in range(m)]
        out = _format_samples(np.concatenate(parts), bigendianp, sgned)
        self._event_idx += m
        self._blocks_popped += m
        self._cur_block = self._blocks_popped
        self._stream_pos += m * bl
        self._block_pos = bl  # same dead state a just-completed block leaves
        w.drop_below(self._blocks_popped)
        return out

    def _bulk_read(self, max_blocks: int, bigendianp: int, sgned: int):
        """Read up to max_blocks whole clean blocks in one numpy slice.

        State-transition-equivalent to that many _read_core iterations
        (pop event → copy whole block → block complete), valid only from a
        block boundary (not block_ready) with whole blocks inside
        total_values and block_len a channel multiple — every clamp in
        decode.c:848-857 is then a no-op. Returns formatted bytes or None.
        """
        h = self._header
        bl = h.block_len
        m = min(max_blocks,
                self._ensure_clean_until() - self._event_idx,
                (self.total_values - self._stream_pos) // bl)
        if m <= 0:
            return None
        pcm = self._ensure_pcm()
        start = self._blocks_popped * bl
        out = _format_samples(pcm[start : start + m * bl], bigendianp, sgned)
        self._event_idx += m
        self._blocks_popped += m
        self._cur_block = self._blocks_popped
        self._stream_pos += m * bl
        self._block_pos = bl  # same dead state a just-completed block leaves
        return out

    # -- public read API ---------------------------------------------------

    def read(self, numbytes: int, bigendianp: int = 0, wordlen: int = 2,
             sgned: int = 1) -> bytes:
        """One acm_read call: at most the remainder of the current block.

        Returns b"" at EOF; raises AcmException on error (module-level
        `acm_read` shim returns C-style codes instead).
        """
        res = self._read_core(numbytes, False, bigendianp, wordlen, sgned)
        if isinstance(res, int):
            raise AcmException(res)
        return res

    def read_loop(self, numbytes: int, bigendianp: int = 0, wordlen: int = 2,
                  sgned: int = 1) -> bytes:
        """acm_read_loop (util.c:258-277): drain until full or EOF. Partial
        data wins over a trailing error; an immediate error raises."""
        got = bytearray()
        left = numbytes
        h = self._header
        bl = h.block_len
        ch = self.info.channels
        fast = wordlen == 2 and (ch <= 1 or bl % ch == 0)
        while left > 0:
            if fast and not self._block_ready and left >= 2 * bl:
                if self._win is not None:
                    res = self._bulk_read_win(left // (2 * bl), bigendianp,
                                              sgned)
                else:
                    res = self._bulk_read(left // (2 * bl), bigendianp, sgned)
                if res:
                    got += res
                    left -= len(res)
                    continue
            res = self._read_core(left, False, bigendianp, wordlen, sgned)
            if isinstance(res, int):  # error code
                if not got:
                    raise AcmException(res)
                break
            if not res:
                break
            got += res
            left -= len(res)
        return bytes(got)

    # -- checkpoint / resume (new capability; SURVEY §5) -------------------

    def get_state(self) -> DecodeState:
        """Snapshot the resumable decode state (cheap, O(1))."""
        return DecodeState(
            stream_pos=self._stream_pos,
            block_pos=self._block_pos,
            block_ready=self._block_ready,
            event_idx=self._event_idx,
            cur_block=self._cur_block,
            blocks_popped=self._blocks_popped,
            end_attempted=self._end_attempted,
            post_seek=self._post_seek,
            force_channels=self.info.channels,
        )

    def set_state(self, st: DecodeState) -> None:
        """O(1) resume from a snapshot taken on a stream of the same file.

        The effective channel count must match (it changes word
        accounting); everything heavy is re-derived lazily from the source.
        """
        if st.force_channels != self.info.channels:
            raise AcmException(
                AcmError.ERR_BADFMT,
                f"state has channels={st.force_channels}, "
                f"stream has {self.info.channels}",
            )
        if self._win is not None:
            self._resume_windowed(st)
        # snapshot semantics are FIRST-pass: forget seek/pass history and
        # any post-seek (dirty-table) synthesis this stream accumulated
        self._pass_history = []
        if self._scan is not None and self._scan.n_exceptions:
            self._pcm = None
        self._stream_pos = st.stream_pos
        self._block_pos = st.block_pos
        self._block_ready = st.block_ready
        self._event_idx = st.event_idx
        self._cur_block = st.cur_block
        self._blocks_popped = st.blocks_popped
        self._end_attempted = st.end_attempted
        self._post_seek = st.post_seek

    def _resume_windowed(self, st: DecodeState) -> None:
        """Re-position the sliding window at a snapshot's decode position.

        The window holds only O(window_blocks) state, so restoring the
        cursors alone would desync it from its block cache and resume
        point; like the reference's backward seek (util.c:214-253) this
        resets and replays forward — O(position) work, O(window) memory.
        The cursors land exactly on the snapshot's values afterwards
        because the decode is deterministic; trailing error events
        consumed at the same word position re-materialize lazily."""
        w = self._win
        # a forward replay may continue the live window ONLY if this
        # stream is still on its first pass: after any backward seek the
        # window's amp table and cached blocks carry dirty-table (pass>1)
        # state, which a snapshot restore must not serve
        if st.stream_pos < self._stream_pos or self._pass_history:
            if not self._can_seek:
                raise AcmException(AcmError.ERR_NOT_SEEKABLE)
            self._stream_pos = 0
            self._block_pos = 0
            self._block_ready = False
            self._event_idx = 0
            self._cur_block = 0
            self._blocks_popped = 0
            self._end_attempted = False
            w.reset()
            # snapshot-replay reproduces FIRST-pass decode: unlike a user
            # seek (which inherits the dirty amp table, reference
            # semantics), a restored snapshot replays the stream from
            # scratch — fresh table and fold state, same as resuming on a
            # fresh stream (set_state clears _pass_history right after)
            w.table = w._native.AmpTable()
            w._folded = w._native.AmpTable()
            w._folded_passes = 0
        while self._stream_pos < st.stream_pos:
            step = min(2048, st.stream_pos - self._stream_pos)
            res = self._read_core(step * 2, True, 0, 2, 1)
            if not isinstance(res, int):
                break  # b"" — stream ended before the snapshot position
            # negative codes: a failed attempt's event was consumed; the
            # original reads continued past it too, so keep replaying
        if self._stream_pos != st.stream_pos:
            raise AcmException(
                AcmError.ERR_OTHER,
                "snapshot position unreachable (different stream?)")
        if st.event_idx > 0:
            # materialize events (and their committed blocks) up to the
            # snapshot's cursor: the replay stops at the word position, but
            # the original may have consumed further events there (failed
            # attempts, or a block popped by a zero-word read) whose
            # ev_bits/blocks raw_tell and the next read will index
            w.ensure_event(st.event_idx - 1)
        if st.end_attempted:
            # raw_tell after a terminal-EOF attempt needs w.end_bits
            while not w.terminal:
                w._fill()
            w.drop_below(st.blocks_popped)

    # -- seeking (util.c:206-253) -----------------------------------------

    def seek_pcm(self, pcm_pos: int) -> int:
        word_pos = pcm_pos * self.info.channels
        if word_pos < self._stream_pos:
            if not self._can_seek:
                raise AcmException(AcmError.ERR_NOT_SEEKABLE)
            # full reset incl. wrapbuf zeroing — our wrap state is implicit
            # in the cached per-block synthesis, so only the cursor resets
            # (windowed mode really does reset + re-decode, like the C).
            # A pass that hit terminal EOF also consumed the TERMINAL
            # attempt (att index len(events)) — its pwr/val updated the
            # reference's table even though no event exists.
            self._pass_history.append(self._event_idx
                                      + (1 if self._end_attempted else 0))
            self._stream_pos = 0
            self._block_pos = 0
            self._block_ready = False
            self._event_idx = 0
            self._cur_block = 0
            self._blocks_popped = 0
            self._end_attempted = False
            self._post_seek = True
            if self._win is not None:
                self._win.reset()  # keeps the amp table, like the C
            elif self._ensure_scan().n_exceptions:
                self._reseed_amp_table()
        while self._stream_pos < word_pos:
            step = min(2048, word_pos - self._stream_pos)
            res = self._read_core(step * 2, True, 0, 2, 1)
            # simulate returns an int count, an error code, or b"" at EOF;
            # the reference breaks on res < 1 (util.c:248-250), errors
            # included — seek swallows them and reports the reached position.
            if not isinstance(res, int) or res < 1:
                break
        return self._stream_pos // self.info.channels

    def _reseed_amp_table(self) -> None:
        """Post-seek re-decode for stale-amp-table (hostile) streams.

        The reference's backward seek zeroes only `wrapbuf` (util.c:230-241);
        its 64 Ki amp table keeps whatever the attempts decoded so far left
        in it, so out-of-range coefficient indexes read DIFFERENT stale
        values on the re-decode pass (verified against the compiled
        reference library). Rebuild the serving PCM from an oracle re-scan
        seeded with the table state this stream's pass history implies.
        Rare: only corrupt/hostile streams have exceptions at all.
        """
        from .scan import oracle as _oracle
        from .ops.synth_torch import decode_scan_result

        scan = self._ensure_scan()
        if scan.att_pwr is None:
            # shouldn't happen — exception streams always come from the
            # oracle (native scan_bytes falls back on oor), which records
            # per-attempt (pwr, val); re-scan defensively if not
            if self._att_scan is None:
                self._att_scan = _oracle.scan_bytes(self._data,
                                                    self._header.n_blocks)
            scan = self._att_scan
        table = scan.table_after(self._pass_history)
        bits = BitReader(self._data[self._header.data_start:])
        scan2 = _oracle.scan_blocks(bits, self._header,
                                    self._header.n_blocks, init_table=table)
        self._pcm = decode_scan_result(
            scan2, backend=self._synth_backend, device=self._device)

    def seek_time(self, pos_ms: int) -> int:
        res = self.seek_pcm(_time2pcm(pos_ms, self.info.rate))
        if res <= 0:
            return res
        return _pcm2time(res, self.info.rate)

    # -- telemetry (util.c:121-200) ---------------------------------------

    @property
    def rate(self) -> int:
        return self.info.rate

    @property
    def channels(self) -> int:
        return self.info.channels

    def seekable(self) -> bool:
        return self._data_len > 0

    def pcm_tell(self) -> int:
        return self._stream_pos // self.info.channels

    def pcm_total(self) -> int:
        return self.total_values // self.info.channels

    def time_tell(self) -> int:
        return _pcm2time(self.pcm_tell(), self.info.rate)

    def time_total(self) -> int:
        return _pcm2time(self.pcm_total(), self.info.rate)

    def raw_total(self) -> int:
        return self._data_len

    def _raw_tell_win(self) -> int:
        """Windowed raw_tell: strict reload pacing reconstructed in O(1).

        The strict reader's loaded-byte count after B consumed bits is
        uniquely min(ceil(B/32)*32, 8*(len+1))/8 (32-bit on-demand reloads,
        avail < 32 — the same invariant seek_to_bit relies on), so the
        windowed scanner only records consumed-bit positions and the exact
        loaded-byte figure is recomputed here; equality with the slurped
        path is asserted in tests/test_stream_windowed.py.
        """
        w = self._win

        def lb(B: int, total_bits: int | None) -> int:
            v = -(-B // 32) * 32
            if total_bits is not None:
                v = min(v, total_bits)
            return v // 8

        # the clamp matters only when B sits inside the file's final
        # (truncated) reload — resolve EOF by reading ahead if needed.
        # Post-seek, reload boundaries restart at data_start (the reader
        # re-opened there), so the extent is data_start-relative; the
        # absolute formula would under-request by up to 3 bytes whenever
        # data_start % 4 != 0 (always, for plain ACM's 14).
        B = (w.end_bits if self._end_attempted
             else w.ev_bits[self._event_idx - 1] if self._event_idx > 0
             else None)
        if B is not None:
            if self._post_seek:
                ds = self._header.data_start
                w.ensure_extent(ds + -(-(B - 8 * ds) // 32) * 4)
            else:
                w.ensure_extent(-(-B // 32) * 4)

        if not self._post_seek:
            total = 8 * (w.file_len + 1) if w.file_len is not None else None
            if self._end_attempted:
                return lb(w.end_bits, total)
            if self._event_idx > 0:
                return lb(w.ev_bits[self._event_idx - 1], total)
            return self._raw_tell0
        ds = self._header.data_start
        total = (8 * (w.file_len - ds + 1)
                 if w.file_len is not None else None)
        if self._end_attempted:
            return ACM_HEADER_LEN + lb(w.end_bits - 8 * ds, total)
        if self._event_idx > 0:
            return ACM_HEADER_LEN + lb(w.ev_bits[self._event_idx - 1] - 8 * ds,
                                       total)
        return ACM_HEADER_LEN

    def raw_tell(self) -> int:
        """Bytes pulled into the bit reservoir so far (util.c:192-195).

        After a backward seek the reference restarts byte accounting at the
        plain-ACM header length (util.c:239 — a quirk it keeps even for
        WAVC); the post-seek reload boundaries are re-simulated exactly.
        """
        if self._win is not None:
            return self._raw_tell_win()
        if not self._post_seek:
            if self._end_attempted:
                return self._ensure_scan().raw_tell_end
            if self._event_idx > 0:
                return int(self._ensure_scan().raw_tell[self._event_idx - 1])
            return self._raw_tell0
        # post-backward-seek accounting, from the data start
        if self._seek_raw_tell is None:
            from .scan import oracle as _oracle

            bits = BitReader(self._data[self._header.data_start :])
            res = _oracle.scan_blocks(bits, self._header, self._header.n_blocks)
            self._seek_raw_tell = np.concatenate(
                [res.raw_tell, [res.raw_tell_end]]
            )
        base = ACM_HEADER_LEN
        if self._end_attempted:
            return base + int(self._seek_raw_tell[-1])
        if self._event_idx > 0:
            return base + int(self._seek_raw_tell[self._event_idx - 1])
        return base

    def bitrate(self) -> int:
        if self.raw_total() == 0:
            return 13000  # author's typical-file fallback (util.c:161-162)
        t = self.time_total()
        if t > 0:
            return 8 * self.raw_total() * 1000 // t
        return 0


def _format_samples(words: np.ndarray, bigendianp: int, sgned: int) -> bytes:
    """s16/u16 × le/be output formats (decode.c:617-655)."""
    if not sgned:
        words = (words.view(np.uint16) ^ np.uint16(0x8000)).view(np.int16)
    if bigendianp:
        return words.astype(">i2").tobytes()
    return words.astype("<i2").tobytes()


def _pcm2time(pcm: int, rate: int) -> int:
    return pcm * 1000 // rate


def _time2pcm(ms: int, rate: int) -> int:
    return ms * rate // 1000


# ---------------------------------------------------------------------------
# Reference-named convenience API (libacm.h:103-170). These are thin, keep
# the C names and call shapes, and raise AcmException (whose .code is the
# C error value) where the C returns a negative code.
# ---------------------------------------------------------------------------


def _as_source(src: Source) -> acmio.AcmIO:
    if isinstance(src, (bytes, bytearray)):
        return acmio.BytesSource(bytes(src))
    if isinstance(src, (str, os.PathLike)):
        return acmio.FileSource(src)
    return src


def acm_open_decoder(src: Source, force_chans: int = 0,
                     window_blocks: int | None = None,
                     device=None) -> AcmStream:
    return AcmStream(_as_source(src), force_chans,
                     window_blocks=window_blocks, device=device)


def acm_open_file(filename: str | os.PathLike, force_chans: int = 0,
                  window_blocks: int | None = None,
                  device=None) -> AcmStream:
    return AcmStream(acmio.FileSource(filename), force_chans,
                     window_blocks=window_blocks, device=device)


def acm_read(acm: AcmStream, numbytes: int, bigendianp: int = 0,
             wordlen: int = 2, sgned: int = 1, simulate: bool = False):
    """C-style: returns bytes (b'' at EOF) or a negative error int.

    simulate=True is the reference's dst=NULL mode (decode.c:859-866):
    decode and advance without formatting, returning the consumed byte
    count (0 at EOF) — what acm_seek_pcm drives internally (util.c:243-251).
    """
    res = acm._read_core(numbytes, simulate, bigendianp, wordlen, sgned)
    if simulate and res == b"":
        return 0
    return res


def acm_read_loop(acm: AcmStream, numbytes: int, bigendianp: int = 0,
                  wordlen: int = 2, sgned: int = 1):
    try:
        return acm.read_loop(numbytes, bigendianp, wordlen, sgned)
    except AcmException as e:
        return e.code


def acm_close(acm: AcmStream) -> None:
    acm.close()


def acm_info(acm: AcmStream) -> ACMInfo:
    return acm.info


def acm_seekable(acm: AcmStream) -> bool:
    return acm.seekable()


def acm_rate(acm: AcmStream) -> int:
    return acm.rate


def acm_channels(acm: AcmStream) -> int:
    return acm.channels


def acm_bitrate(acm: AcmStream) -> int:
    return acm.bitrate()


def acm_pcm_tell(acm: AcmStream) -> int:
    return acm.pcm_tell()


def acm_pcm_total(acm: AcmStream) -> int:
    return acm.pcm_total()


def acm_time_tell(acm: AcmStream) -> int:
    return acm.time_tell()


def acm_time_total(acm: AcmStream) -> int:
    return acm.time_total()


def acm_raw_tell(acm: AcmStream) -> int:
    return acm.raw_tell()


def acm_raw_total(acm: AcmStream) -> int:
    return acm.raw_total()


def acm_seek_pcm(acm: AcmStream, pcm_pos: int) -> int:
    try:
        return acm.seek_pcm(pcm_pos)
    except AcmException as e:
        return e.code


def acm_seek_time(acm: AcmStream, pos_ms: int) -> int:
    try:
        return acm.seek_time(pos_ms)
    except AcmException as e:
        return e.code
