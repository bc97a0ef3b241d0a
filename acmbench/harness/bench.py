"""One run of one cell, found by name in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by the names BENCHMARK.json gives:

- a configuration: the JSON file its `file` names (acmbench/configs/);
- a traffic mix: acmbench/traffic/<traffic>.json, whose `loop` names the
  general loop that reads it (acmbench/loops/<loop>.py: set-up, the
  measured window and the check, driven by the mix's parameters);
- a per-layer metric: acmbench/metrics/<name>.py, whose `read(run)`
  returns the number, or None where the run holds nothing to read.

So a cell, a mix (of a loop that exists) or a metric is added by adding
files and entries, never by editing a file.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import tempfile
import time

#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "libacm_tpu"})


@dataclasses.dataclass
class Spec:
    """A cell, with its configuration and traffic mix read from files."""

    root: pathlib.Path
    bench: dict
    cell: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.cell["name"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self.reports(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self.reports(m)]

    def reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_spec(root: pathlib.Path, workload: str) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = _named(bench["workloads"], workload, "workload")
    conf = _named(bench["configs"], cell["config"], "config")
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "acmbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    return Spec(root, bench, cell, config, traffic)


def metric_reader(root: pathlib.Path, name: str):
    """The `read` function of acmbench/metrics/<name>.py."""
    path = root / "acmbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "acmbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """The state of one run that the loop fills and the metrics read."""

    spec: Spec
    seed: int
    seconds: float
    trace: bool
    #: torch devices the cell runs on (a list of one for a one-chip cell)
    devices: list
    tmp: str
    tracer: object = None
    setup_s: float = 0.0
    #: end-to-end metrics the loop measured, by name
    e2e: dict = dataclasses.field(default_factory=dict)
    #: what the loop recorded for the per-layer metrics
    record: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    #: {name: (number compared, its limit)}
    checks: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0

    @property
    def params(self) -> dict:
        return self.spec.traffic

    @property
    def device_kwargs(self) -> dict:
        """How the program's corpus entry is told where to run."""
        if len(self.devices) == 1:
            return {"device": self.devices[0]}
        return {"devices": list(self.devices)}

    def sync(self) -> None:
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def loop_module(spec: Spec):
    return importlib.import_module(f"acmbench.loops.{spec.traffic['loop']}")


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             devices: list, t_start: float) -> Run:
    """Set up, measure for `seconds`, then check against the plain
    reference; the run's numbers are in the returned Run."""
    import torch

    from .trace import Tracer

    loop = loop_module(spec)
    with tempfile.TemporaryDirectory(prefix="acmbench-") as tmp:
        run = Run(spec, seed, seconds, trace, devices, tmp)
        run.tracer = Tracer(trace, devices, tmp)
        state = loop.setup(run)
        run.sync()
        # the set-up heap (torch, the program, the data) is frozen out of
        # the collector's passes, as long-running Python servers do: a
        # full pass over it stalls every thread for tens of milliseconds
        gc.collect()
        gc.freeze()
        run.setup_s = time.perf_counter() - t_start
        with run.tracer.window():
            loop.window(run, state)
            run.sync()
        run.memory_peak_bytes = max(
            (torch.cuda.max_memory_allocated(d) for d in devices
             if d.type == "cuda"), default=0)
        loop.check(run, state)
    return run


def correct(run: Run) -> bool:
    return all(v <= lim for v, lim in run.checks.values())


def metrics(run: Run) -> dict:
    """With tracing off the cell's end-to-end metrics, with it on its
    per-layer metrics (those whose reader found something)."""
    spec = run.spec
    out = {}
    if not run.trace:
        for m in spec.end_to_end():
            v = run.setup_s if m["name"] == "setup_s" else run.e2e.get(
                m["name"])
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in spec.per_layer():
        v = metric_reader(spec.root, m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
