"""Host scan rate: the traced passes' decoded samples over the program's
own scan time (CorpusSummary.scan_s, summed over the passes)."""


def read(run):
    passes, work = run.record.get("passes"), run.record.get("work")
    scan_s = sum(p["scan_s"] for p in passes or [])
    if not passes or scan_s <= 0:
        return None
    return len(passes) * work["samples"] / scan_s / 1e6
