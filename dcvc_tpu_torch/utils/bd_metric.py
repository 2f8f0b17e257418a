"""Bjøntegaard metrics (BD-rate / BD-PSNR).

Standard Bjøntegaard delta computation: cubic polynomial fit of the RD
curve in (log-rate, distortion) space, integrated over the overlapping
distortion interval.  (The reference depends on the pip package
bd_metric.bjontegaard_metric; this is a self-contained implementation of
the same standard algorithm, VCEG-M33.)
"""

import numpy as np


def _bd_int(x, y, lo, hi):
    """Integral of the cubic fit of y(x) over [lo, hi]."""
    p = np.polyfit(x, y, 3)
    p_int = np.polyint(p)
    return np.polyval(p_int, hi) - np.polyval(p_int, lo)


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test,
            extrapolate=False):
    """BD-rate in percent (negative = test saves rate vs anchor).

    With extrapolate=True, disjoint distortion ranges fall back to
    integrating both cubic fits over the UNION range (an extrapolated,
    clearly-out-of-spec number — useful to keep untrained/sanity runs
    comparable end-to-end; standard VCEG-M33 otherwise)."""
    lr_a = np.log(np.asarray(rate_anchor, np.float64))
    lr_t = np.log(np.asarray(rate_test, np.float64))
    d_a = np.asarray(psnr_anchor, np.float64)
    d_t = np.asarray(psnr_test, np.float64)

    lo = max(d_a.min(), d_t.min())
    hi = min(d_a.max(), d_t.max())
    if hi <= lo:
        if not extrapolate:
            return float("nan")
        lo = min(d_a.min(), d_t.min())
        hi = max(d_a.max(), d_t.max())

    # fit log-rate as a function of distortion
    int_a = _bd_int(d_a, lr_a, lo, hi)
    int_t = _bd_int(d_t, lr_t, lo, hi)
    avg_exp_diff = (int_t - int_a) / (hi - lo)
    return (np.exp(avg_exp_diff) - 1) * 100


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test):
    """BD-PSNR in dB (positive = test better at equal rate)."""
    lr_a = np.log(np.asarray(rate_anchor, np.float64))
    lr_t = np.log(np.asarray(rate_test, np.float64))
    d_a = np.asarray(psnr_anchor, np.float64)
    d_t = np.asarray(psnr_test, np.float64)

    lo = max(lr_a.min(), lr_t.min())
    hi = min(lr_a.max(), lr_t.max())
    if hi <= lo:
        return float("nan")

    int_a = _bd_int(lr_a, d_a, lo, hi)
    int_t = _bd_int(lr_t, d_t, lo, hi)
    return (int_t - int_a) / (hi - lo)


# aliases matching the reference's import surface
BD_RATE = bd_rate
BD_PSNR = bd_psnr
