"""Host time in the copies to the cards a pass: the program's
`libacm.corpus.copy` spans (the submitter thread blocked in each wire
blob's copy from pageable memory) in ms over the traced passes."""

from acmbench.harness import spans


def read(run):
    return spans.span_ms_per_pass(run, "libacm.corpus.copy")
