"""Traffic categories for per-category bytes-per-token calibration.

The paper (§2.1) tracks one EMA ratio per *traffic category* k — e.g. code,
prose, CJK — because tokenizer fertility varies ~3.4x across writing systems.
The category is metadata the routing layer already has (model tag, tenant,
detected script); we model it as a small closed enum plus "mixed/other".

The ``TRUE_BYTES_PER_TOKEN`` values are the ground-truth ratios used by the
synthetic trace generator and by the Table-4 Monte-Carlo calibration study;
they match the paper's reported per-category ratios (§2.1, Table 4).
"""

from __future__ import annotations

import enum


class Category(enum.IntEnum):
    """Traffic category of a request (known at dispatch time)."""

    ENGLISH_PROSE = 0
    SOURCE_CODE = 1
    CJK_TEXT = 2
    MIXED_OTHER = 3


NUM_CATEGORIES = len(Category)

#: Ground-truth bytes-per-token ratios per category (paper Table 4, col. 2).
TRUE_BYTES_PER_TOKEN: dict[Category, float] = {
    Category.ENGLISH_PROSE: 4.48,
    Category.SOURCE_CODE: 3.52,
    Category.CJK_TEXT: 2.01,
    Category.MIXED_OTHER: 3.81,
}

#: Observation noise (std of per-request bytes/token around the category
#: mean) used by the trace generator; chosen so the EMA σ̂ is meaningfully
#: non-zero, as in real traffic.
BYTES_PER_TOKEN_STD: dict[Category, float] = {
    Category.ENGLISH_PROSE: 0.35,
    Category.SOURCE_CODE: 0.40,
    Category.CJK_TEXT: 0.20,
    Category.MIXED_OTHER: 0.55,
}

#: Cold-start prior c0 (paper §2.1): the English-prose average.
COLD_START_RATIO = 4.0

CATEGORY_NAMES = {
    Category.ENGLISH_PROSE: "English prose",
    Category.SOURCE_CODE: "Source code",
    Category.CJK_TEXT: "CJK text",
    Category.MIXED_OTHER: "Mixed / other",
}
