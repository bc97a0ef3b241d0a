"""Header pass a pass: the program's `libacm.corpus.headers` spans (peek,
header parse and bucketing of every file, on the calling thread) in ms
over the traced passes."""

from acmbench.harness import spans


def read(run):
    return spans.span_ms_per_pass(run, "libacm.corpus.headers")
