"""Table 4: per-category EMA calibration convergence (Monte Carlo), on the PyTorch port.

The port of ``benchmarks/table4_calibration.py``: the same rows and derived values,
through ``repro_torch`` only (no jax); host arithmetic, no device.

Setup mirrors the paper's: synthetic per-category request streams with known
bytes-per-token ratios (uniform category mix), Azure-shaped total-token
distribution. After n=50 observations per category:

paper: rel. error ≤3.5%; calibrated mis-route <1% per category; global
static c=4 baseline 4.1% (CJK worst: the 2× ratio error systematically
under-counts tokens and false-routes to the short pool).
"""

from __future__ import annotations

import numpy as np

from benchmarks.common import emit, time_us
from repro_torch.core import (
    CATEGORY_NAMES,
    TRUE_BYTES_PER_TOKEN,
    Category,
    EmaCalibrator,
)
from repro_torch.core.categories import BYTES_PER_TOKEN_STD
from repro_torch.traces.cdf import AZURE


def _stream(cat: Category, n: int, rng: np.random.Generator):
    """Synthetic per-category stream: (byte_len, true_in, max_out) tuples."""
    totals = AZURE.sample_totals(rng, n)
    l_in, l_out = AZURE.sample_split(rng, totals)
    c = rng.normal(
        TRUE_BYTES_PER_TOKEN[cat], BYTES_PER_TOKEN_STD[cat], size=n
    ).clip(0.5)
    bytes_ = np.maximum(1, np.round(l_in * c)).astype(np.int64)
    return bytes_, l_in, l_out


def run(n_obs: int = 50, n_eval: int = 2500, b_short: int = 8192, seed: int = 42):
    rng = np.random.default_rng(seed)
    out = {}
    static = EmaCalibrator()  # never observes → global static c0 = 4.0
    static_miss, static_total = 0, 0

    for cat in Category:
        wb, wi, wo = _stream(cat, n_obs, rng)
        eb, ei, eo = _stream(cat, n_eval, rng)

        def calibrate():
            c = EmaCalibrator()
            for b, i in zip(wb, wi):
                c.observe(int(b), int(i), int(cat))
            return c

        us = time_us(calibrate, repeats=3)
        cal = calibrate()
        true_c = TRUE_BYTES_PER_TOKEN[cat]
        est_c = cal.ratio[int(cat)]
        rel_err = abs(est_c - true_c) / true_c

        def misroute(c: EmaCalibrator) -> float:
            miss = 0
            for b, i, o in zip(eb, ei, eo):
                est = c.estimate_total_budget(int(b), int(o), int(cat))
                if (est <= b_short) != (int(i + o) <= b_short):
                    miss += 1
            return miss / n_eval

        m_cal = misroute(cal)
        m_static = misroute(static)
        static_miss += int(m_static * n_eval)
        static_total += n_eval
        emit(
            f"table4/{CATEGORY_NAMES[cat].replace(' ', '_')}",
            us,
            f"true_c={true_c:.2f};est_c={est_c:.2f};rel_err={rel_err:.3f};"
            f"misroute={m_cal:.4f};static_misroute={m_static:.4f}",
        )
        out[CATEGORY_NAMES[cat]] = {
            "true": true_c, "est": est_c, "rel_err": rel_err,
            "misroute": m_cal, "static": m_static,
        }
    emit(
        "table4/global_static_c4",
        0.0,
        f"misroute={static_miss/static_total:.4f}",
    )
    out["static"] = static_miss / static_total
    return out


if __name__ == "__main__":
    run()
