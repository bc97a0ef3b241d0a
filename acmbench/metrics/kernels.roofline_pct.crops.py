"""Kernels' share of their roofline in the traced window: the least time
the window's crops need on the card (acmbench/harness/roofline.py: the
payload of each crop's own blocks read once and 2 B a delivered sample
written once, against the fewest synthesis operations of the delivered
samples; counted from the inputs, so warm-up and pad blocks count as no
work) over the device time of the program's kernels in the window: every
kernel but the loop's fold (loops/crops.py FOLD_KERNELS), the consumer's
work and not the read's (copies and fills left out)."""

from acmbench.harness import roofline
from acmbench.loops.crops import FOLD_KERNELS


def read(run):
    t, n, work = (run.tracer.summary, run.record.get("batches"),
                  run.record.get("work"))
    if t is None or not t.complete or not n or not work:
        return None
    kernel_s = sum(e.dur_us for e in t.of("kernel")
                   if not any(f in e.name for f in FOLD_KERNELS)) / 1e6
    if kernel_s <= 0:
        return None
    least = roofline.least_time_s(work["payload_bytes"], work["samples"],
                                  work["synth_ops"])
    return least / kernel_s * 100
