"""The calling thread blocked on the submitter a pass: the program's
`libacm.corpus.wait` spans (at the bound on dispatches in flight and at
the final drain) in ms over the traced passes."""

from acmbench.harness import spans


def read(run):
    return spans.span_ms_per_pass(run, "libacm.corpus.wait")
