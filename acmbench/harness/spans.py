"""The program's own spans and counters, for the per-layer metrics that
read them.

The program (libacm_tpu_torch.utils.profiling) records spans and counters
only while a torch profiler records, so in a `--trace 1` run its record
holds exactly the measured window: the warm pass and the check run with no
profiler. The record holds every thread's spans, the submitter thread's
too, which the benchmark's own profiler leaves out of its trace.

Each reader here returns None where the program recorded nothing: a
program without the facility, or a run without the profiler.
"""

from __future__ import annotations


def totals() -> dict | None:
    """The program's totals ({"spans": {name: {"count", "total_s",
    "self_s"}}, "counters": {name: n}}), or None where it recorded no
    span."""
    try:
        from libacm_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "totals", None)
    if read is None:
        return None
    t = read()
    return t if t.get("spans") else None


def _passes(run) -> list | None:
    return run.record.get("passes") or None


def span_ms_per_pass(run, name: str) -> float | None:
    """Σ seconds of the spans named `name`, in ms a traced pass (0 where
    the program recorded other spans but none of these)."""
    t, passes = totals(), _passes(run)
    if t is None or passes is None:
        return None
    s = t["spans"].get(name)
    return (s["total_s"] if s else 0.0) / len(passes) * 1e3


def counter_per_pass(run, name: str) -> float | None:
    """The counter `name` a traced pass (0 where the program recorded
    spans but never counted this)."""
    t, passes = totals(), _passes(run)
    if t is None or passes is None:
        return None
    return t["counters"].get(name, 0) / len(passes)


def span_share_pct(run, name: str) -> float | None:
    """Σ seconds of the spans named `name` over Σ the traced passes'
    wall seconds, in %."""
    t, passes = totals(), _passes(run)
    if t is None or passes is None:
        return None
    wall = sum(p["wall_s"] for p in passes)
    if wall <= 0:
        return None
    s = t["spans"].get(name)
    return (s["total_s"] if s else 0.0) / wall * 100
