"""Image comparison metrics (``gvr_tpu/utils/image.py``)."""

from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    m = mse(a, b)
    if m <= 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / m)
