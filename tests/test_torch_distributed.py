"""The port's multi-process path: 2 and 4 local processes over gloo on
the CPU compose shard_manifest + decode_corpus_device + allreduce_summary
to the same totals as one process, as tests/test_distributed_multiprocess.py
does for the JAX package. Each child runs under its own timeout, so a
hung rendezvous fails fast."""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from libacm_tpu import testing
from libacm_tpu.parallel import decode_corpus_device as jax_decode
from libacm_tpu_torch.parallel import (CorpusSummary, decode_corpus_device,
                                       distributed)

_WORKER = pathlib.Path(__file__).resolve().parent / "_torch_dist_worker.py"
#: seconds for all children of one case, imports and rendezvous included
_CHILD_TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_procs,n_files,shard_sizes", [
    (2, 9, [5, 4]),
    # 4 ranks, uneven manifest: a rank that gets fewer files
    (4, 10, [3, 3, 2, 2]),
])
def test_torch_multi_process_decode_matches_single(tmp_path, n_procs,
                                                   n_files, shard_sizes):
    rng = np.random.default_rng(2026)
    for i in range(n_files):
        (tmp_path / f"f{i:02d}.acm").write_bytes(
            testing.speech_acm_bytes(rng, level=int(rng.choice([3, 5])),
                                     rows=16, n_blocks=3,
                                     channels=int(rng.integers(1, 3))))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(_WORKER), coord, str(n_procs), str(i),
             str(tmp_path), "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for i in range(n_procs)
    ]
    deadline = time.monotonic() + _CHILD_TIMEOUT
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail("distributed workers timed out")
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()

    result = next(l for l in outs[0].splitlines() if l.startswith("RESULT "))
    totals = json.loads(result[len("RESULT "):])
    shards = []
    for out in outs:
        line = next(l for l in out.splitlines() if l.startswith("SHARD "))
        shards.append(json.loads(line[len("SHARD "):]))

    # single-process ground truth, from the port and from the JAX package
    paths = [str(p) for p in sorted(tmp_path.glob("*.acm"))]
    solo = decode_corpus_device(paths, device="cpu")
    jsolo = jax_decode(paths).block_until_ready()
    for key in ("n_ok", "n_failed", "n_partial", "samples"):
        assert totals[key] == getattr(solo.summary, key), key
        assert totals[key] == getattr(jsolo.summary, key), key
    assert totals["n_files"] == n_files
    assert [s["files"] for s in shards] == shard_sizes
    assert totals["shard_files"] == shard_sizes[0]
    assert (sum(s["checksum"] for s in shards) & 0xFFFFFFFF
            == solo.checksum() == int(jsolo.checksum()) & 0xFFFFFFFF)
    assert all(s["device"] == "cpu" for s in shards)


def test_torch_distributed_solo_is_identity(monkeypatch):
    """No coordinator and no launcher environment: a solo run. The shard
    is the whole manifest and the reduction the identity."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    assert not tdist.is_initialized()
    paths = list("abcdefg")
    assert distributed.shard_manifest(paths) == paths
    assert distributed.shard_manifest(paths, 1, 3) == ["b", "e"]
    assert [len(distributed.shard_manifest(paths, i, 4))
            for i in range(4)] == [2, 2, 2, 1]
    s = CorpusSummary(n_files=3, n_ok=2, samples=10, wall_s=1.5)
    assert distributed.allreduce_summary(s) is s


def test_torch_distributed_explicit_arguments_propagate_failures(
        monkeypatch):
    """Explicit arguments mean multi-process: a bad call raises instead
    of degrading to a solo run; NCCL without a card for the rank raises
    and does not fall through to gloo."""
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("127.0.0.1:1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        distributed.initialize("127.0.0.1:1", 2, 1, backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="share a card"):
        distributed.initialize("127.0.0.1:1", 2, 1, backend="nccl")
    assert not tdist.is_initialized()


def test_torch_distributed_launcher_environment_joins(monkeypatch):
    """With a launcher's environment set and no arguments the group is
    joined from it; a second call is a no-op."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        distributed.initialize()
        assert tdist.is_initialized() and tdist.get_backend() == "gloo"
        distributed.initialize("127.0.0.1:1", 7, 3)  # already joined: no-op
        assert tdist.get_world_size() == 1
        assert distributed.shard_manifest(list("abc")) == list("abc")
        s = CorpusSummary(n_files=1)
        assert distributed.allreduce_summary(s) is s
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
