"""Tracing on torch.profiler: the program's spans and counters.

The port of libacm_tpu/utils/profiling.py. The reference's only
performance tooling is `acmtool -n` (decode with output discarded,
acmtool.c:402). Here:

- `trace(dir)` — context manager around torch.profiler.profile (host, and
  the card's kernels and copies when CUDA is available, every thread):
  on exit it exports a Chrome/Perfetto trace of everything inside into
  `dir`. View with ui.perfetto.dev or chrome://tracing.
- `LIBACM_TPU_TORCH_PROFILE=<dir>` — the port's acmtool wraps its decode
  loop in `trace(dir)` when this is set (no CLI-flag change, so the
  reference's exact flag surface stays intact).
- `call(name)`, `span(name)`, `count(name, n)` — the program's own spans
  and counters (names start with `libacm.`). They record only while a
  torch profiler records: `call` asks the profiler once, at the entry of
  one call of the program (one `decode_corpus_device`, one `checksum()`),
  and every span inside it follows that answer. A recording span enters
  a record function of its name (torch's C++ `_RecordFunctionFast`, a
  tenth of `torch.profiler.record_function`'s cost; its events carry the
  category `cpu_op`), so it lands in the exported trace on the profiler's
  clock beside the kernels and copies it caused, and appends a
  `SpanRecord` to an in-memory record stamped with `time.time_ns()`, the
  clock the profiler maps its events to (an exported `ts` is that clock
  less the trace's `baseTimeNanoseconds`, in microseconds). With recording
  off, `call` and `span` return one shared no-op context and `count` does
  nothing.

The profiler's state is thread-local. A worker thread that serves a call
is handed the call's root span and opens its spans under it
(`span(name, parent=root)`); they enter the in-memory record whatever the
profiler sees, and the exported trace only where the profiler records
every thread (as `trace` does). `totals()` reduces the record, `records()`
copies it and `reset()` clears it; it grows while recording is on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

#: environment variable naming the trace directory of the port's acmtool
PROFILE_ENV = "LIBACM_TPU_TORCH_PROFILE"

#: the record function a span enters: torch's C++ one where torch has it
#: (about 1 µs against 10 for torch.profiler.record_function, whose
#: Python wrapper and two dispatched ops cost a traced pass a few per cent)
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.profiler.record_function)


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span, on the `time.time_ns()` clock."""

    name: str
    id: int
    #: the enclosing span's id (on this thread, or the root handed to a
    #: worker thread); None for the root of a call
    parent: int | None
    #: the root's id, shared by every span of one call of the program
    call: int
    #: the OS thread id, as the exported trace's `tid` gives it
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_LOCK = threading.Lock()
_RECORD: list[SpanRecord] = []
_COUNTERS: dict[str, int] = {}
_IDS = itertools.count(1)
_TLS = threading.local()


class _Off:
    """The shared no-op span of a call that does not record."""

    __slots__ = ()
    recording = False
    ns = 0

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class Span:
    """A recording span: enter it with `with`, once."""

    __slots__ = ("name", "id", "parent", "call", "attrs", "start_ns",
                 "end_ns", "_rf")
    recording = True

    def __init__(self, name: str, parent: "Span | None", attrs: dict):
        self.name = name
        self.id = next(_IDS)
        self.parent = None if parent is None else parent.id
        self.call = self.id if parent is None else parent.call
        self.attrs = attrs
        self.start_ns = self.end_ns = 0

    @property
    def ns(self) -> int:
        """The finished span's duration in nanoseconds."""
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        self.start_ns = time.time_ns()
        self._rf = _record_function(self.name)
        self._rf.__enter__()
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        rec = SpanRecord(self.name, self.id, self.parent, self.call,
                         threading.get_native_id(), self.start_ns,
                         self.end_ns, self.attrs)
        with _LOCK:
            _RECORD.append(rec)
        return False


def recording() -> bool:
    """Whether a torch profiler records: on this thread (the C flag), or on
    every thread (`profile_all_threads`, which leaves that flag unset and
    sets the profiler module's own)."""
    return (torch.autograd._profiler_enabled()
            or getattr(_autograd_profiler, "_is_profiler_enabled", False))


def call(name: str, **attrs) -> Span | _Off:
    """The root span of one call of the program. Inside an open span of
    this thread it is that span's child, of the same call; otherwise it
    asks the profiler whether to record, once."""
    stack = getattr(_TLS, "stack", None)
    if stack:
        return Span(name, stack[-1], attrs)
    if not recording():
        return OFF
    return Span(name, None, attrs)


def span(name: str, parent: Span | _Off | None = None,
         **attrs) -> Span | _Off:
    """A span inside the innermost open span of this thread, or inside
    `parent` (a call's root handed to a worker thread); the no-op when
    neither records."""
    if parent is None:
        stack = getattr(_TLS, "stack", None)
        if not stack:
            return OFF
        parent = stack[-1]
    elif not parent.recording:
        return OFF
    return Span(name, parent, attrs)


def count(name: str, n: int) -> None:
    """Add n to a counter, while a span of this thread records."""
    if not getattr(_TLS, "stack", None):
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def records() -> list[SpanRecord]:
    """The finished spans recorded since the last reset(), in order of
    their end."""
    with _LOCK:
        return list(_RECORD)


def totals() -> dict:
    """{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: n}}. A span's self time is its duration less the part its
    children on the same thread cover."""
    with _LOCK:
        recs, counters = list(_RECORD), dict(_COUNTERS)
    thread = {r.id: r.thread for r in recs}
    child_ns: dict[int, int] = {}
    for r in recs:
        if r.parent is not None and thread.get(r.parent) == r.thread:
            child_ns[r.parent] = (child_ns.get(r.parent, 0)
                                  + r.end_ns - r.start_ns)
    spans: dict[str, dict] = {}
    for r in recs:
        t = spans.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        ns = r.end_ns - r.start_ns
        t["count"] += 1
        t["total_s"] += ns / 1e9
        t["self_s"] += (ns - child_ns.get(r.id, 0)) / 1e9
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Clear the record and the counters."""
    with _LOCK:
        _RECORD.clear()
        _COUNTERS.clear()


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike):
    """Profile the enclosed block on every thread; write its Chrome trace
    into log_dir."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch.profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=acts, experimental_config=every_thread) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"libacm_tpu_torch.{os.getpid()}.{time.time_ns()}"
                 ".pt.trace.json"))


@contextlib.contextmanager
def maybe_trace_from_env():
    """trace(...) if LIBACM_TPU_TORCH_PROFILE is set, else no-op."""
    log_dir = os.environ.get(PROFILE_ENV)
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield
