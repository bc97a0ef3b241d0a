"""Copies to the card: bytes over device time of the profiler's
host-to-device memcpy events in the traced passes."""


def read(run):
    t = run.tracer.summary
    if t is None or not t.complete:
        return None
    ev = [e for e in t.of("gpu_memcpy", "HtoD") if e.nbytes is not None]
    us = sum(e.dur_us for e in ev)
    if not ev or us <= 0:
        return None
    return sum(e.nbytes for e in ev) / (us / 1e6) / 1e9
