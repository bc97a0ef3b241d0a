"""Host time a batch enqueueing read_batch's device work: the
program's `libacm.random_access.launch` spans (the unpack, synthesis and
gather launches) in ms over the traced window's batches."""

from acmbench.harness import spans


def read(run):
    t, n = spans.totals(), run.record.get("batches")
    if t is None or not n:
        return None
    s = t["spans"].get("libacm.random_access.launch")
    return (s["total_s"] if s else 0.0) / n * 1e3
