"""Device operations (kernels, copies, fills) in the traced window over the
segments it served."""


def read(run):
    t, n = run.tracer.summary, run.record.get("requests")
    if t is None or not t.complete or not n:
        return None
    return len(t.events) / n
