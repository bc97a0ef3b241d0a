"""Multi-process corpus decode: process bootstrap, manifest sharding, metrics.

Counterpart of `libacm_tpu/parallel/distributed.py` on torch.distributed.
The distributed story is deliberately thin because corpus decode is
embarrassingly parallel across files: each process decodes its static
shard of the manifest on its own device, and the only communication is
the reduction of the summary counters.

That vector is host data, five int64 values. The default backend is gloo,
which carries it on any machine, ranks that share a card included. NCCL
works only where every rank has a card of its own (it refuses two ranks on
one card): ask for it with `backend="nccl"`, and a rank whose card does
not exist raises instead of falling through to another backend.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import torch
import torch.distributed as dist

from .corpus import CorpusSummary

logger = logging.getLogger("libacm_tpu_torch.distributed")

#: what a launcher (torchrun) sets for every process it starts
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _nccl_card(rank: int) -> torch.device:
    """The card of this rank under NCCL: $LOCAL_RANK where a launcher set
    it, else the rank itself (every process on one host)."""
    idx = int(os.environ.get("LOCAL_RANK", rank))
    if not torch.cuda.is_available() or idx >= torch.cuda.device_count():
        raise RuntimeError(
            f"backend 'nccl' needs a card for every rank: rank {rank} "
            f"would take card {idx} of "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; ranks that share a card reduce over backend 'gloo'")
    return torch.device("cuda", idx)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """torch.distributed bootstrap (no-op if already initialized).

    With explicit arguments the caller wants multi-process — failures then
    PROPAGATE (a silently-degraded "distributed" job that decodes only its
    own shard is worse than a crash). `coordinator_address` is
    "host:port"; the process group is joined over tcp://. With no
    arguments this is a solo run, unless a launcher's environment
    (RANK, WORLD_SIZE, MASTER_ADDR) is set: then the group is joined from
    it, and failures propagate too. `backend=None` is gloo.
    """
    if dist.is_initialized():
        return
    backend = backend or "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        if backend == "nccl":
            _nccl_card(process_id)
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
        return
    if all(k in os.environ for k in _LAUNCHER_ENV):
        if backend == "nccl":
            _nccl_card(int(os.environ["RANK"]))
        dist.init_process_group(backend)  # env://
        return
    logger.debug("no coordinator and no launcher environment: solo run")


def _rank_and_count() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_manifest(paths: Sequence, process_index: int | None = None,
                   process_count: int | None = None) -> list:
    """Static round-robin shard of a corpus manifest for this process.

    Round-robin (not contiguous) so size-correlated orderings spread evenly.
    Deterministic given the manifest order — every process computes its own
    shard with no communication. One process when no group was joined.
    """
    rank, count = _rank_and_count()
    pi = rank if process_index is None else process_index
    pc = count if process_count is None else process_count
    return [p for i, p in enumerate(paths) if i % pc == pi]


def allreduce_summary(local: CorpusSummary) -> CorpusSummary:
    """Sum per-process corpus summaries across all processes; wall_s and
    scan_s stay this process's own. The identity on a single process."""
    rank, count = _rank_and_count()
    if count == 1:
        return local
    vec = torch.tensor(
        [local.n_files, local.n_ok, local.n_failed, local.n_partial,
         local.samples], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        vec = vec.to(_nccl_card(rank))
    gathered = [torch.empty_like(vec) for _ in range(count)]
    dist.all_gather(gathered, vec)
    total = torch.stack(gathered).sum(dim=0).tolist()
    return CorpusSummary(
        n_files=total[0], n_ok=total[1], n_failed=total[2],
        n_partial=total[3], samples=total[4],
        wall_s=local.wall_s, scan_s=local.scan_s,
    )
