"""The port's evidence tools on the CPU: tools/torch_rss_sweep.py refuses
to run without a card and rehearses its control flow with --device cpu
(its times then say nothing of a card); tools/torch_unpack_ab.py,
tools/torch_unpack_probe.py and tools/torch_unpack_blocks_ab.py refuse to
run without a card."""

import importlib.util
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tool(name: str):
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [("torch_rss_sweep", ["20"]),
                                       ("torch_unpack_ab", []),
                                       ("torch_unpack_probe", []),
                                       ("torch_unpack_blocks_ab", [])])
def test_tools_exit_2_without_a_card(name, argv, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _tool(name).main(argv) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_rss_sweep_rehearsal_holds_its_budget(capsys):
    assert _tool("torch_rss_sweep").main(["40", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "n=40" in out and "cached_files=8" in out
    assert "device_peak=n/a" in out and out.rstrip().endswith("OK")
