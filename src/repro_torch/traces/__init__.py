"""Trace CDFs and synthetic request generation (paper Appendix A)."""

from repro_torch.traces.cdf import AZURE, LMSYS, TRACES, BucketCDF, describe, get_trace_cdf
from repro_torch.traces.generator import (
    CATEGORY_MIX,
    RATE_PROFILES,
    TraceColumns,
    TraceSpec,
    generate_trace,
    generate_trace_columns,
    short_fraction,
)

__all__ = [
    "AZURE",
    "LMSYS",
    "TRACES",
    "BucketCDF",
    "describe",
    "get_trace_cdf",
    "CATEGORY_MIX",
    "RATE_PROFILES",
    "TraceColumns",
    "TraceSpec",
    "generate_trace",
    "generate_trace_columns",
    "short_fraction",
]
