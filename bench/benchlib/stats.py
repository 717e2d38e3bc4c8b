"""Order statistics of the harness."""
from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float:
    """The ``q``-th percentile by nearest rank over all ``values`` (an
    infinite value, a request never served, sorts last)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]

