"""Tracing/profiling hooks on torch.profiler.

The port of libacm_tpu/utils/profiling.py. The reference's only
performance tooling is `acmtool -n` (decode with output discarded,
acmtool.c:402). Here:

- `trace(dir)` — context manager around torch.profiler.profile (host, and
  the card's kernels and copies when CUDA is available): on exit it
  exports a Chrome/Perfetto trace of everything inside into `dir`. View
  with ui.perfetto.dev or chrome://tracing.
- `annotate(name)` — torch.profiler.record_function, for labeling
  host-side pipeline stages (scan, assemble, dispatch) inside a trace.
- `LIBACM_TPU_TORCH_PROFILE=<dir>` — the port's acmtool wraps its decode
  loop in `trace(dir)` when this is set (no CLI-flag change, so the
  reference's exact flag surface stays intact).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

#: environment variable naming the trace directory of the port's acmtool
PROFILE_ENV = "LIBACM_TPU_TORCH_PROFILE"


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike):
    """Profile the enclosed block; write its Chrome trace into log_dir."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"libacm_tpu_torch.{os.getpid()}.{time.time_ns()}"
                 ".pt.trace.json"))


def annotate(name: str):
    """Label a host-side region inside an active trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def maybe_trace_from_env():
    """trace(...) if LIBACM_TPU_TORCH_PROFILE is set, else no-op."""
    log_dir = os.environ.get(PROFILE_ENV)
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield
