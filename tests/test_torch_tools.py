"""The port's evidence tools on the CPU: tools/torch_phase_probe.py and
tools/torch_rss_sweep.py refuse to run without a card and rehearse their
control flow with --device cpu (their times then say nothing of a card);
tools/torch_unpack_ab.py, tools/torch_unpack_probe.py and
tools/torch_unpack_blocks_ab.py refuse to run without a card."""

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


@pytest.mark.parametrize("name,argv", [("torch_phase_probe", []),
                                       ("torch_rss_sweep", ["20"]),
                                       ("torch_unpack_ab", []),
                                       ("torch_unpack_probe", []),
                                       ("torch_unpack_blocks_ab", [])])
def test_tools_exit_2_without_a_card(name, argv, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _tool(name).main(argv) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_phase_probe_rehearsal_names_every_phase(capsys):
    from libacm_tpu_torch.parallel import corpus

    before = (corpus._scan_cols_wire, corpus._dispatch_cols_wire)
    assert _tool("torch_phase_probe").main(
        ["--device", "cpu", "--scale", "0.02"]) == 0
    # the wrapped pipeline halves are put back
    assert (corpus._scan_cols_wire, corpus._dispatch_cols_wire) == before
    out = capsys.readouterr().out
    assert out.startswith("cpu rehearsal")
    rounds = [ln for ln in out.splitlines() if ln.startswith("round ")]
    assert len(rounds) == 2 and all("checksum" in ln and " ok" in ln
                                    for ln in rounds)
    chunk_lines = [ln for ln in out.splitlines() if " chunk " in ln]
    assert len(chunk_lines) == 8  # four geometries, twice
    for key in ("scan=", "coalesce=", "copy=", "unpack_enqueue=",
                "kernel_launch=", "drain="):
        assert all(key in ln for ln in chunk_lines), key


def test_rss_sweep_rehearsal_holds_its_budget(capsys):
    assert _tool("torch_rss_sweep").main(["40", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "n=40" in out and "cached_files=8" in out
    assert "device_peak=n/a" in out and out.rstrip().endswith("OK")
