"""The C++ scanner a pass: the program's `libacm.corpus.scan.native`
spans (one native call a device group of a chunk) in ms over the traced
passes."""

from acmbench.harness import spans


def read(run):
    return spans.span_ms_per_pass(run, "libacm.corpus.scan.native")
