"""Staging in the host scan a pass: the program's
`libacm.corpus.scan.stage` spans (each chunk's file bytes read back to back
into the scanner's buffer) in ms over the traced passes."""

from acmbench.harness import spans


def read(run):
    return spans.span_ms_per_pass(run, "libacm.corpus.scan.stage")
