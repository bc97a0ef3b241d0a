"""Published peaks of one NVIDIA H100 SXM and the least time a corpus pass
needs on it: the yardstick of `kernels.roofline_pct.ingest`.

Work is counted from the inputs, never from the program's chunk shapes,
so the count stays right when kernels fuse or chunking changes: the ACM
payload of every file read once and the int16 PCM of every good block
written once, against the fewest int32 operations of synthesis (the
count of the port's bench, frozen here: per sample 1 to dequantize, 2 a
filterbank pass, 1 for the shift, and the pass-0 bias on 2 / cols of the
samples).
"""

from __future__ import annotations

#: HBM3 bandwidth and the int32 ALU rate (132 SMs x 64 INT32 lanes x
#: 1.98 GHz), NVIDIA's data sheet and Hopper white paper, at 700 W
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def synth_ops(level: int, samples: int) -> int:
    """The fewest int32 operations that synthesize `samples` samples at
    `level`."""
    cols = 1 << level
    return samples * (2 + 2 * level) + (samples * 2 // cols if level else 0)


def least_time_s(payload_bytes: int, samples: int, ops: int) -> float:
    """The larger of the bytes bound (payload read once, int16 PCM written
    once, over HBM bandwidth) and the operations bound."""
    return max((payload_bytes + 2 * samples) / HBM_BYTES_PER_S,
               ops / INT32_OPS_PER_S)
