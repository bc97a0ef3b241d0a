"""How much PCM the C reference's CLI writes for a stream: a frozen copy of
the read-loop arithmetic of acmtool -d (markokr/libacm src/acmtool.c:269-310,
util.c:258-277, decode.c:826-876), for the benchmark's plain reference."""

from __future__ import annotations

import numpy as np


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
