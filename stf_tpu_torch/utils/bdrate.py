"""Bjøntegaard-delta metrics (BD-rate / BD-PSNR), the port's own copy of
`stf_tpu/utils/bdrate.py`.

Standard implementation (cubic polynomial fit of quality vs log-rate,
integrated over the overlapping quality range), the metric the reference's
published RD curves are compared with in the compression literature.
Negative BD-rate = the test codec needs fewer bits at equal quality.
"""

from typing import Sequence

import numpy as np


def _fit(rate, dist):
    rate = np.asarray(rate, np.float64)
    dist = np.asarray(dist, np.float64)
    order = np.argsort(dist)
    return np.log(rate[order]), dist[order]


def _bd_averages(x1, y1, x2, y2, axis_name: str):
    """Fit y(x) cubics for both curves and return each curve's average y
    over the overlapping x range (the shared Bjøntegaard integration)."""
    deg = min(3, len(x1) - 1, len(x2) - 1)
    if deg < 1:
        raise ValueError("need at least 2 RD points per curve")
    p1 = np.polyfit(x1, y1, deg)
    p2 = np.polyfit(x2, y2, deg)
    lo = max(x1.min(), x2.min())
    hi = min(x1.max(), x2.max())
    if hi <= lo:
        raise ValueError(f"RD curves do not overlap in {axis_name}")
    i1 = np.polyint(p1)
    i2 = np.polyint(p2)
    avg1 = (np.polyval(i1, hi) - np.polyval(i1, lo)) / (hi - lo)
    avg2 = (np.polyval(i2, hi) - np.polyval(i2, lo)) / (hi - lo)
    return avg1, avg2


def bd_rate(
    rate_ref: Sequence[float],
    dist_ref: Sequence[float],
    rate_test: Sequence[float],
    dist_test: Sequence[float],
) -> float:
    """Average rate difference (%) of test vs reference at equal quality."""
    lr1, d1 = _fit(rate_ref, dist_ref)
    lr2, d2 = _fit(rate_test, dist_test)
    avg1, avg2 = _bd_averages(d1, lr1, d2, lr2, "quality")
    return float((np.exp(avg2 - avg1) - 1) * 100)


def bd_quality(
    rate_ref: Sequence[float],
    dist_ref: Sequence[float],
    rate_test: Sequence[float],
    dist_test: Sequence[float],
) -> float:
    """Average quality difference (dB) of test vs reference at equal rate."""
    lr1, d1 = _fit(rate_ref, dist_ref)
    lr2, d2 = _fit(rate_test, dist_test)
    avg1, avg2 = _bd_averages(lr1, d1, lr2, d2, "rate")
    return float(avg2 - avg1)


def rate_delta_at_quality(
    rate_ref: Sequence[float],
    dist_ref: Sequence[float],
    rate: float,
    dist: float,
) -> float:
    """Single-point comparison: % rate difference vs the reference curve at
    this point's quality (log-linear interpolation of the curve)."""
    lr, d = _fit(rate_ref, dist_ref)
    if not (d.min() <= dist <= d.max()):
        raise ValueError(
            f"quality {dist:.3f} outside the reference curve "
            f"[{d.min():.3f}, {d.max():.3f}]"
        )
    ref_log_rate = np.interp(dist, d, lr)
    return float((rate / np.exp(ref_log_rate) - 1) * 100)
