"""The benchmark on the card: one short run of each cell that fits the
machine, through acmbench/run.py as the driver starts it. Marked `cuda`;
each test skips where the card (or the cards a cell asks for) is missing.

    python -m pytest acmbench/tests -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from acmbench.tests import tiny

CELLS = json.loads((tiny.REPO / "BENCHMARK.json").read_text())["workloads"]


@pytest.fixture
def cards():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS, ids=[c["name"] for c in CELLS])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct_on_the_card(cards, cell, trace):
    if cards < cell["chips"]:
        pytest.skip(f"{cell['name']} needs {cell['chips']} cards")
    r = subprocess.run(
        [sys.executable, "acmbench/run.py", "--workload", cell["name"],
         "--seed", str(2**32 + 77), "--seconds", "3", "--trace", str(trace)],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == cell["chips"]
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    else:
        assert "setup_s" in line["metrics"]
