"""What the benchmark's runs may load, and that cells and metrics are found
by name: every cell of BENCHMARK.json rehearsed at a tiny size on the CPU
in a process of its own, the reference alone in another, a cell and a
metric added as files to a copy, and run.py's exits without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest

from acmbench import run as run_py
from acmbench.harness import bench
from acmbench.tests import tiny

CELLS = [c["name"] for c in json.loads(
    (tiny.REPO / "BENCHMARK.json").read_text())["workloads"]
         + tiny.PENDING["workloads"]]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_no_jax_and_no_jax_package(checkout, cell):
    out = tiny.rehearse(checkout, cell)
    assert out["correct"], out["checks"]
    assert not set(out["modules"]) & bench.FORBIDDEN_MODULES
    assert "libacm_tpu_torch" in out["modules"]


def test_reference_loads_nothing_of_the_program(checkout):
    code = (
        "import json, sys\n"
        "from acmbench.gen import pool\n"
        "from acmbench.harness import expect\n"
        "cfg = json.load(open('acmbench/configs/fallout-1000.json'))\n"
        "expect.expected(pool.make_corpus(cfg, 5), 'cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=str(checkout))
    r = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    mods = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not mods & (bench.FORBIDDEN_MODULES | {"libacm_tpu_torch"})


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A new mix of the ingest loop, a cell that uses it and a per-layer
    metric: new files and new entries in BENCHMARK.json, no file edited."""
    root = tiny.checkout(tmp_path)
    bdir = root / "acmbench"
    before = {p: p.read_bytes() for p in bdir.rglob("*") if p.is_file()}
    (bdir / "traffic" / "ingest-small-chunks.json").write_text(json.dumps(
        {"loop": "ingest", "pack": True, "chunk_files": 2}))
    (bdir / "metrics" / "dummy.passes_counted.py").write_text(
        "def read(run):\n    return len(run.record['passes'])\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "fallout-1000.ingest-small-chunks",
                           "config": "fallout-1000",
                           "traffic": "ingest-small-chunks", "chips": 1,
                           "why": "a dummy cell"})
    b["per_layer"].append({"name": "dummy.passes_counted", "unit": "passes",
                           "better": "higher", "source": "host_clock",
                           "layer": "corpus pipeline",
                           "moves": "decode_Msamples_per_s",
                           "workloads": ["fallout-1000.ingest-small-chunks"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    out = tiny.rehearse(root, "fallout-1000.ingest-small-chunks", trace=1)
    assert out["correct"]
    assert "dummy.passes_counted" in out["read"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "libacm_tpu_torch_x",
                        types.ModuleType("libacm_tpu_torch_x"))
    assert run_py.loaded_forbidden(bench.FORBIDDEN_MODULES) == []
    monkeypatch.setitem(sys.modules, "libacm_tpu.parallel",
                        types.ModuleType("libacm_tpu.parallel"))
    assert run_py.loaded_forbidden(bench.FORBIDDEN_MODULES) == ["libacm_tpu"]


def _run_py(root, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "acmbench/run.py", "--workload",
         "fallout-1000.ingest", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)


def test_run_exits_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run_py(tiny.REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_run_exits_in_a_directory_of_the_benchmark_alone(tmp_path):
    root = tiny.checkout(tmp_path)
    r = _run_py(root)
    assert r.returncode != 0 and r.stdout.strip() == ""
