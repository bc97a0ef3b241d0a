"""Where the port's CUDA kernels are built: $LIBACM_TPU_TORCH_CACHE when
set (beside the scanner copy's objects), else `_build/` in the package;
each source (csrc/synth.cu, csrc/unpack.cu, csrc/checksum.cu,
csrc/unpack_blocks.cu) into its own shared object keyed by its hash, all
of them through ops.kernels, which also resets and reads every launch
counter. nvcc is faked: only the paths are under test."""

import pathlib
import subprocess
import threading

import pytest

from libacm_tpu_torch.ops import (checksum_cuda, kernels, synth_cuda,
                                  unpack_blocks_cuda, unpack_cuda)
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


@pytest.mark.parametrize("mod,stem", [(checksum_cuda, "checksum"),
                                      (unpack_blocks_cuda, "unpack_blocks")])
def test_checksum_and_block_unpack_build_under_cache_variable(
        fake_nvcc, monkeypatch, tmp_path, mod, stem):
    """csrc/checksum.cu and csrc/unpack_blocks.cu: each its own hash-keyed
    object in the same directory, built once, beside the others; a
    changed source builds a new object."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("LIBACM_TPU_TORCH_CACHE", str(cache))
    monkeypatch.setattr(synth_cuda, "_HERE",
                        pathlib.Path("/proc/no/such/package/ops"))
    so, report = mod.build()
    assert so.parent == cache and so.exists() and report == "ptxas info"
    assert so.name.startswith(f"{stem}-") and so.suffix == ".so"
    assert so.name[len(stem) + 1:-3].isalnum()  # <stem>-<hash>.so
    cmd = " ".join(fake_nvcc[0])
    assert "sm_90a" in cmd and cmd.endswith(f"csrc/{stem}.cu")
    again, report = mod.build()
    assert again == so and report == "" and len(fake_nvcc) == 1
    unpack_so, _ = unpack_cuda.build()
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [so.name, unpack_so.name])
    src = tmp_path / f"{stem}.cu"
    src.write_text("// changed")
    monkeypatch.setattr(mod, "_SRC", src)
    changed, _ = mod.build()
    assert changed != so and changed.name.startswith(f"{stem}-")


def test_build_all_builds_every_source_once(fake_nvcc, monkeypatch,
                                            tmp_path):
    """ops.kernels.build_all: one nvcc for each CUDA source of the
    package, every csrc/*.cu, each into its own object; then cached."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("LIBACM_TPU_TORCH_CACHE", str(cache))
    built = kernels.build_all()
    assert list(built) == list(kernels.MODULES)
    sources = sorted(pathlib.Path(cmd[-1]).name for cmd in fake_nvcc)
    csrc = pathlib.Path(synth_cuda.__file__).resolve().parent.parent / "csrc"
    assert sources == sorted(p.name for p in csrc.glob("*.cu"))
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        so.name for so, _, _ in built.values())
    assert all(report == "ptxas info" and t >= 0
               for _, report, t in built.values())
    again = kernels.build_all()
    assert len(fake_nvcc) == len(kernels.MODULES)
    assert [so for so, _, _ in again.values()] == [
        so for so, _, _ in built.values()]


def test_every_kernel_module_is_listed():
    """Every ops module that builds a kernel is in kernels.MODULES, with
    one Launches counter that its reset_launches resets."""
    ops = pathlib.Path(kernels.__file__).parent
    with_build = sorted(p.stem for p in ops.glob("*.py")
                        if "\ndef build(" in p.read_text())
    assert with_build == sorted(kernels.MODULES)
    for mod in kernels.modules():
        assert isinstance(mod.launches, kernels.Launches) and mod.launches
        name = next(iter(mod.launches))
        mod.launches.count(name)
        assert mod.launches[name] >= 1
        mod.reset_launches()
        assert not any(mod.launches.values())


def test_reset_all_and_all_launches():
    """all_launches merges every module's counts into one new dict;
    reset_all sets every one to 0; counts from many threads add up."""
    kernels.reset_all()
    names = [k for mod in kernels.modules() for k in mod.launches]
    assert kernels.all_launches() == dict.fromkeys(names, 0)
    assert len(names) == len(set(names))  # no kernel named twice

    def bump():
        for _ in range(1000):
            checksum_cuda.launches.count("checksum")
            unpack_blocks_cuda.launches.count("unpack_blocks")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    synth_cuda.launches.count("synth_tail")
    got = kernels.all_launches()
    assert got == dict.fromkeys(names, 0) | {
        "checksum": 8000, "unpack_blocks": 8000, "synth_tail": 1}
    got["checksum"] = -1  # a copy: the counters are untouched
    assert checksum_cuda.launches["checksum"] == 8000
    kernels.reset_all()
    assert not any(kernels.all_launches().values())
