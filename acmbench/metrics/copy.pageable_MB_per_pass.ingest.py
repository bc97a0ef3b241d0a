"""Bytes copied to the cards from pageable host memory a pass: the
program's counter `libacm.copy.h2d_bytes.pageable` (every wire blob handed
to a card whose memory is not pinned) in MB (10^6 bytes) over the traced
passes."""

from acmbench.harness import spans


def read(run):
    n = spans.counter_per_pass(run, "libacm.copy.h2d_bytes.pageable")
    return None if n is None else n / 1e6
