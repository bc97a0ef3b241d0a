"""Kernels' share of their roofline in the traced passes: the least time
the passes' inputs need on the card (acmbench/harness/roofline.py, counted
from each file's payload and good blocks) over the device time of every
kernel in the window (copies and fills left out)."""

from acmbench.harness import roofline


def read(run):
    t, passes, work = (run.tracer.summary, run.record.get("passes"),
                       run.record.get("work"))
    if t is None or not t.complete or not passes:
        return None
    kernel_s = sum(e.dur_us for e in t.of("kernel")) / 1e6
    if kernel_s <= 0:
        return None
    n = len(passes)
    least = roofline.least_time_s(n * work["payload_bytes"],
                                  n * work["samples"], n * work["synth_ops"])
    return least / kernel_s * 100
