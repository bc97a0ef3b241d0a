"""Worker process for the port's multi-process tests.

Usage: python _torch_dist_worker.py <coordinator> <num_procs> <proc_id>
                                    <corpus_dir> [device]

Joins the torch.distributed group over gloo, decodes this process's
static manifest shard on `device` (default: the card), all-reduces the
summary, and (process 0) prints the global totals as one `RESULT {...}`
JSON line; every process prints its `SHARD {...}` line (files, checksum,
device, kernel launches).
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    coord, n, pid, corpus_dir = sys.argv[1:5]
    device = sys.argv[5] if len(sys.argv) > 5 else None
    import torch.distributed as tdist

    from libacm_tpu_torch.ops import kernels
    from libacm_tpu_torch.parallel import decode_corpus_device
    from libacm_tpu_torch.parallel import distributed as dist

    dist.initialize(coord, int(n), int(pid))
    if tdist.get_world_size() != int(n):
        raise RuntimeError(f"world size {tdist.get_world_size()} != {n}")
    try:
        paths = sorted(pathlib.Path(corpus_dir).glob("*.acm"))
        mine = dist.shard_manifest(paths)
        out = decode_corpus_device([str(p) for p in mine],
                                   device=device).block_until_ready()
        local_sum = int(out.checksum())
        summary = dist.allreduce_summary(out.summary)
        if tdist.get_rank() == 0:
            d = summary.as_dict()
            d["shard_files"] = len(mine)
            print("RESULT " + json.dumps(d), flush=True)
        print("SHARD " + json.dumps(
            {"files": len(mine), "checksum": local_sum,
             "device": str(out.device),
             "launches": kernels.all_launches()}), flush=True)
    finally:
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
