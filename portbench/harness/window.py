"""The window's arithmetic: the end-to-end metrics from the passes' times."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between the two
    nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def end_to_end(pass_s, window_s: float, samples_per_pass: int, setup_s: float) -> dict:
    """msamples_per_s: every sample the window's passes completed over the
    whole window's wall time; pass_p95_ms: the 95th percentile of all
    passes' times; setup_s as measured."""
    return {
        "msamples_per_s": samples_per_pass * len(pass_s) / window_s / 1e6,
        "pass_p95_ms": percentile(pass_s, 95.0) * 1e3,
        "setup_s": setup_s,
    }
