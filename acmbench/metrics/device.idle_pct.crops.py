"""Device idle share of the traced window: 1 less the union of device
activity over the window, averaged over the cell's cards."""

from acmbench.harness import trace


def read(run):
    return trace.idle_pct(run.tracer.summary)
