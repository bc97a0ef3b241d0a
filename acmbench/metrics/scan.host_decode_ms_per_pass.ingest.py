"""Whole-file host decodes inside the scan a pass: the program's
`libacm.corpus.scan.host_decode` spans (one a stale-amp-table file or an
event-list overflow rescan) in ms over the traced passes."""

from acmbench.harness import spans


def read(run):
    return spans.span_ms_per_pass(run, "libacm.corpus.scan.host_decode")
