"""The open-loop scheduler: requests arrive on a seeded schedule whatever the
system does, and each is timed from when it was due.

Independent users make an open loop: a slow system does not receive less
load, its queue grows. `run_open_loop` hands requests to a fixed number of
worker threads in the order they are due; a worker that takes a request
before its time waits for it, and one that takes it late serves it at once.
A request's latency runs from its due time to the end of its `serve`, so
the wait a stall imposes on later requests counts; how late the workers
picked requests up is reported beside it.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np


def poisson_arrivals(rng: np.random.Generator, rate: float,
                     seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson process of
    `rate` a second, those before `seconds`."""
    n = int(rate * seconds * 1.5) + 64
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, n))])
    return t[t < seconds]


@dataclasses.dataclass
class OpenLoopResult:
    #: seconds from each request's due time to the end of its serve
    latency_s: np.ndarray
    #: seconds by which a worker picked each request up late (0: on time)
    late_s: np.ndarray
    #: the exception each request raised, or None
    errors: list
    #: window length: from the first due time to the last completion
    wall_s: float

    @property
    def failed(self) -> int:
        return sum(e is not None for e in self.errors)


def run_open_loop(due_s: np.ndarray, serve, workers: int,
                  lead_s: float = 0.005) -> OpenLoopResult:
    """Serve request i (serve(i)) at due_s[i] seconds after the start, on
    `workers` threads; returns when every request has been served."""
    n = len(due_s)
    latency = np.zeros(n)
    late = np.zeros(n)
    errors: list = [None] * n
    lock = threading.Lock()
    nxt = [0]
    t0 = time.perf_counter() + lead_s
    done_at = [t0]

    def worker() -> None:
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= n:
                return
            due = t0 + float(due_s[i])
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = max(0.0, time.perf_counter() - due)
            try:
                serve(i)
            except Exception as exc:  # counted as a failed request
                errors[i] = exc
            end = time.perf_counter()
            latency[i] = end - due
            with lock:
                done_at[0] = max(done_at[0], end)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return OpenLoopResult(latency, late, errors, done_at[0] - t0)
