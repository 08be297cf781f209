"""The benchmark's arithmetic on samples."""
from __future__ import annotations

import math
from typing import Sequence


def mean(values: Sequence[float]) -> float:
    return sum(values) / len(values) if values else math.nan
