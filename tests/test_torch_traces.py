"""The port's trace generator and CDFs (copies with the NumPy RNG) against
the reference's: identical columns and requests for both traces, several
seeds and the non-stationary knobs.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import traces as R  # noqa: E402
from repro_torch import traces as T  # noqa: E402

COLUMN_FIELDS = [f.name for f in dataclasses.fields(T.TraceColumns)]


def spec_pair(**kw):
    return T.TraceSpec(**kw), R.TraceSpec(**kw)


def assert_columns_equal(port, ref):
    assert [f.name for f in dataclasses.fields(R.TraceColumns)] == COLUMN_FIELDS
    for name in COLUMN_FIELDS:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("trace", ["azure", "lmsys"])
def test_columns_bit_identical(trace, seed):
    tp, rp = spec_pair(trace=trace, num_requests=3000, rate=400.0, seed=seed)
    assert_columns_equal(T.generate_trace_columns(tp), R.generate_trace_columns(rp))


@pytest.mark.parametrize("trace", ["azure", "lmsys"])
def test_requests_identical(trace):
    tp, rp = spec_pair(trace=trace, num_requests=500, rate=100.0, seed=7)
    port, ref = T.generate_trace(tp), R.generate_trace(rp)
    assert [dataclasses.astuple(r) for r in port] == [dataclasses.astuple(r) for r in ref]


@pytest.mark.parametrize(
    "knobs",
    [
        dict(rate_profile="burst", rate_amplitude=2.0, rate_period=2.0),
        dict(rate_profile="diurnal", rate_amplitude=0.5, mix_drift=0.5, drift_trace="lmsys"),
        dict(rate_profile="step", rate_amplitude=1.0, rate_period=3.0),
        dict(bytes_drift=0.3, cap_style="padded"),
        dict(cap_style="bucket"),
    ],
)
def test_nonstationary_columns_identical(knobs):
    tp, rp = spec_pair(trace="azure", num_requests=1500, rate=300.0, seed=3, **knobs)
    assert_columns_equal(T.generate_trace_columns(tp), R.generate_trace_columns(rp))


def test_cdf_tables_identical():
    for name in ("azure", "lmsys"):
        p, r = T.get_trace_cdf(name), R.get_trace_cdf(name)
        assert dataclasses.astuple(p) == dataclasses.astuple(r)
        u = np.linspace(0.0, 1.0, 257)
        assert [p.inverse(v) for v in u] == [r.inverse(v) for v in u]
        assert [p.cdf(x) for x in range(0, 70_000, 97)] == [r.cdf(x) for x in range(0, 70_000, 97)]
    assert T.short_fraction(T.generate_trace(spec_pair(num_requests=400, seed=2)[0]), 8192) == (
        R.short_fraction(R.generate_trace(spec_pair(num_requests=400, seed=2)[1]), 8192)
    )
