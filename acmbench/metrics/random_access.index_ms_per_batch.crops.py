"""Host time a batch in read_batch's index lookups: the program's
`libacm.random_access.index` spans (each crop's clip looked up in the
corpus's caches: its bytes and block index) in ms over the traced
window's batches."""

from acmbench.harness import spans


def read(run):
    t, n = spans.totals(), run.record.get("batches")
    if t is None or not n:
        return None
    s = t["spans"].get("libacm.random_access.index")
    return (s["total_s"] if s else 0.0) / n * 1e3
