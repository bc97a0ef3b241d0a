"""Blocks synthesized beyond what the crops need: the program's counters
`libacm.random_access.warmup_blocks` (each span's warm-up blocks) and
`libacm.random_access.pad_blocks` (blocks past a crop's own, the rounding
of a launch's block count included) over `libacm.random_access.blocks`
(every block synthesized), in %, in the traced window."""

from acmbench.harness import spans


def read(run):
    t = spans.totals()
    if t is None or not run.record.get("batches"):
        return None
    c = t["counters"]
    blocks = c.get("libacm.random_access.blocks", 0)
    if blocks <= 0:
        return None
    return (c.get("libacm.random_access.warmup_blocks", 0)
            + c.get("libacm.random_access.pad_blocks", 0)) / blocks * 100
