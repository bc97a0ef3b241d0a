"""The port's entry file stays runnable: entry() against the JAX package's
flagship step, and the dry run of the multi-device pipeline over CPU
shards, as tests/test_graft_entry.py holds `__graft_entry__.py`."""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import __graft_entry__ as graft  # noqa: E402
import __graft_entry_torch__ as tgraft  # noqa: E402


def test_torch_entry_matches_jax_entry():
    """Same seed, same 7/16 example, same bits (PCM and final carry)."""
    jfn, jargs = graft.entry()
    tfn, targs = tgraft.entry()
    for a, b in zip(jargs, targs):
        np.testing.assert_array_equal(a, b)
    want = jax.jit(jfn)(*jargs)
    got = tfn(*(torch.from_numpy(a) for a in targs))
    assert got[0].dtype == torch.int16
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_torch_dryrun_multidevice_over_cpu_shards(n):
    # asserts bit-exactness of every leg internally
    tgraft.dryrun_multidevice(["cpu"] * n)


def test_torch_dryrun_never_skips_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LIBACM_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgraft.dryrun_multidevice()
    with pytest.raises(RuntimeError, match="CUDA"):
        tgraft.dryrun_multidevice(["cuda:0", "cuda:0"])


def test_torch_entry_file_runs_as_a_program():
    r = subprocess.run([sys.executable, str(ROOT / "__graft_entry_torch__.py"),
                        "cpu", "cpu", "cpu"], capture_output=True, text=True,
                       timeout=240, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "entry OK" in r.stdout and "dryrun_multidevice OK" in r.stdout
