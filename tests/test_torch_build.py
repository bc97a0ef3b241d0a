"""Where the port's CUDA kernels are built: $LIBACM_TPU_TORCH_CACHE when
set (beside the scanner copy's objects), else `_build/` in the package;
each source (csrc/synth.cu, csrc/unpack.cu) into its own shared object
keyed by its hash. nvcc is faked: only the paths are under test."""

import pathlib
import subprocess

import pytest

from libacm_tpu_torch.ops import synth_cuda, unpack_cuda
from libacm_tpu_torch.scan import native


@pytest.fixture
def fake_nvcc(monkeypatch):
    """A stand-in for nvcc that writes its -o target; yields the commands
    it was given."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, stdout="",
                                           stderr="ptxas info")

    monkeypatch.setattr(synth_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(synth_cuda.subprocess, "run", run)
    return calls


def test_kernel_builds_under_cache_variable(fake_nvcc, monkeypatch, tmp_path):
    cache = tmp_path / "cache"
    monkeypatch.setenv("LIBACM_TPU_TORCH_CACHE", str(cache))
    # a package directory that cannot be written no longer matters
    monkeypatch.setattr(synth_cuda, "_HERE",
                        pathlib.Path("/proc/no/such/package/ops"))
    so, report = synth_cuda.build()
    assert so.parent == cache and so.exists() and report == "ptxas info"
    assert so.name.startswith("synth-") and so.suffix == ".so"
    assert len(fake_nvcc) == 1 and "sm_90a" in " ".join(fake_nvcc[0])
    assert [p.name for p in cache.iterdir()] == [so.name]  # no temp left
    again, report = synth_cuda.build()  # cached by source hash
    assert again == so and report == "" and len(fake_nvcc) == 1


def test_kernel_builds_in_package_by_default(fake_nvcc, monkeypatch,
                                             tmp_path):
    monkeypatch.delenv("LIBACM_TPU_TORCH_CACHE", raising=False)
    monkeypatch.setattr(synth_cuda, "_HERE", tmp_path / "pkg" / "ops")
    so, _ = synth_cuda.build()
    assert so.parent == tmp_path / "pkg" / "_build"
    monkeypatch.setenv("LIBACM_TPU_TORCH_CACHE", "")  # empty: unset
    assert synth_cuda.build_dir() == tmp_path / "pkg" / "_build"


def test_failed_build_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("LIBACM_TPU_TORCH_CACHE", str(tmp_path))
    monkeypatch.setattr(synth_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(
        synth_cuda.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, stdout="",
                                                      stderr="boom"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        synth_cuda.build()
    assert list(tmp_path.iterdir()) == []


def test_kernel_and_scanner_share_the_variable():
    """One variable names both build directories."""
    assert synth_cuda.CACHE_ENV == "LIBACM_TPU_TORCH_CACHE"
    assert f'"{synth_cuda.CACHE_ENV}"' in pathlib.Path(
        native.__file__).read_text()


def test_unpack_kernel_builds_under_cache_variable(fake_nvcc, monkeypatch,
                                                  tmp_path):
    """csrc/unpack.cu: its own hash-keyed object in the same directory,
    built once, beside (not instead of) the synthesis kernel's."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("LIBACM_TPU_TORCH_CACHE", str(cache))
    monkeypatch.setattr(synth_cuda, "_HERE",
                        pathlib.Path("/proc/no/such/package/ops"))
    so, report = unpack_cuda.build()
    assert so.parent == cache and so.exists() and report == "ptxas info"
    assert so.name.startswith("unpack-") and so.suffix == ".so"
    cmd = " ".join(fake_nvcc[0])
    assert "sm_90a" in cmd and cmd.endswith("csrc/unpack.cu")
    again, report = unpack_cuda.build()
    assert again == so and report == "" and len(fake_nvcc) == 1
    synth_so, _ = synth_cuda.build()
    assert synth_so.name.startswith("synth-") and len(fake_nvcc) == 2
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [so.name, synth_so.name])


def test_unpack_object_follows_its_source(fake_nvcc, monkeypatch, tmp_path):
    """A changed unpack.cu builds a new object; the default directory is
    the package's _build/."""
    monkeypatch.delenv("LIBACM_TPU_TORCH_CACHE", raising=False)
    monkeypatch.setattr(synth_cuda, "_HERE", tmp_path / "pkg" / "ops")
    src = tmp_path / "unpack.cu"
    src.write_text("// one")
    monkeypatch.setattr(unpack_cuda, "_SRC", src)
    first, _ = unpack_cuda.build()
    assert first.parent == tmp_path / "pkg" / "_build"
    src.write_text("// two")
    second, _ = unpack_cuda.build()
    assert second != first and len(fake_nvcc) == 2
    assert second.name.startswith("unpack-")
