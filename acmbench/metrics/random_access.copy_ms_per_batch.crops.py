"""Host time a batch copying read_batch's blob in: the program's
`libacm.random_access.copy` spans (each geometry's wire, the host-decoded
rows and the metadata laid into one pinned blob, and its copy to the card
enqueued) in ms over the traced window's batches."""

from acmbench.harness import spans


def read(run):
    t, n = spans.totals(), run.record.get("batches")
    if t is None or not n:
        return None
    s = t["spans"].get("libacm.random_access.copy")
    return (s["total_s"] if s else 0.0) / n * 1e3
