"""Share of the window the one submitter thread was busy: the program's
`libacm.corpus.dispatch` spans (coalesce, copy and kernel enqueue of each
chunk, for every card) over the traced passes' wall seconds, in %."""

from acmbench.harness import spans


def read(run):
    return spans.span_share_pct(run, "libacm.corpus.dispatch")
