"""Small statistics the loops and the sweep share."""

from __future__ import annotations

import numpy as np


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=float), 95))
