"""Stream copies: device time of the host-to-device and device-to-host
memcpys in the traced window over the tracks it played."""


def read(run):
    t, n = run.tracer.summary, run.record.get("tracks")
    if t is None or not t.complete or not n:
        return None
    ev = t.of("gpu_memcpy", "HtoD") + t.of("gpu_memcpy", "DtoH")
    if not ev:
        return None
    return sum(e.dur_us for e in ev) / 1e3 / n
