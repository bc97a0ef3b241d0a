"""Host time a batch in read_batch's span scans: the program's
`libacm.random_access.scan` spans (one a geometry of the batch: the
spans' bytes staged back to back and one native scan call) in ms over
the traced window's batches."""

from acmbench.harness import spans


def read(run):
    t, n = spans.totals(), run.record.get("batches")
    if t is None or not n:
        return None
    s = t["spans"].get("libacm.random_access.scan")
    return (s["total_s"] if s else 0.0) / n * 1e3
