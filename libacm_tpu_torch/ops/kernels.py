"""The port's hand-written CUDA kernels as one list: build every source,
and reset and read every launch counter, without naming the modules.

Each module of `MODULES` holds a kernel source (`build()`) and one
`Launches` counter (`launches`), which its wrappers bump where they launch
a kernel and nowhere else. A module added to `MODULES` is built by
`build_all`, reset by `reset_all` and read by `all_launches` wherever
those are called (chip_smoke.py, bench_torch.py, the process-group
worker).
"""

from __future__ import annotations

import importlib
import pathlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

#: the modules that hold a CUDA kernel, in the order their builds are
#: reported and their counts merged
MODULES = ("synth_cuda", "unpack_cuda", "checksum_cuda",
           "unpack_blocks_cuda")


class Launches(dict):
    """Launches per kernel since the last reset(), {kernel: count}; the
    dispatch threads of several decodes may count at once."""

    def __init__(self, *kernels: str):
        super().__init__(dict.fromkeys(kernels, 0))
        self._lock = threading.Lock()

    def count(self, kernel: str) -> None:
        with self._lock:
            self[kernel] += 1

    def reset(self) -> None:
        with self._lock:
            for kernel in self:
                self[kernel] = 0


def modules() -> list:
    """The kernel modules of MODULES, imported."""
    return [importlib.import_module(f"{__package__}.{m}") for m in MODULES]


def reset_all() -> None:
    """Every kernel's launch count set to 0."""
    for mod in modules():
        mod.launches.reset()


def all_launches() -> dict[str, int]:
    """Every kernel's launches since its last reset, as one new dict."""
    out: dict[str, int] = {}
    for mod in modules():
        out |= mod.launches
    return out


def build_all() -> dict[str, tuple[pathlib.Path, str, float]]:
    """Compile every module's source for sm_90a, one nvcc for each, all
    started together: {module: (shared object, nvcc's -Xptxas -v report,
    seconds from the start until it was built)}."""
    mods = modules()
    t0 = time.perf_counter()

    def one(mod):
        so, report = mod.build()
        return so, report, time.perf_counter() - t0

    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(pool.map(one, mods))
    return {m.__name__.rsplit(".", 1)[1]: b for m, b in zip(mods, built)}
