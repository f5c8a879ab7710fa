"""Sort/select/statistics utilities (the reference's L6 layer, toolbox.h/.cpp).

A copy of pnr_tpu/utils/stats.py.

The reference ships hand-rolled quicksort/quickselect/top-K templates;
in an array framework these are library one-liners, but the exact
semantics (the quantile index convention, the mode tie-break) are part
of the behavioural surface and are reproduced here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def quantile(a: Sequence[float], ratio_num: int, ratio_den: int) -> float:
    """k-th order statistic with k = floor(n * num/den), k = n-1 when
    num >= den (toolbox.cpp:121-136 `quantile` / quickselect)."""
    arr = np.asarray(a)
    n = arr.size
    if n == 0:
        raise ValueError("empty input")
    k = n - 1 if ratio_num >= ratio_den else int(np.floor(n * (ratio_num / ratio_den)))
    k = min(max(k, 0), n - 1)
    return np.partition(arr, k)[k]


def mode(vals: Sequence[int]) -> int:
    """Histogram peak; on ties the FIRST value to reach the peak count in
    input order wins (toolbox.cpp:17-59 `mode`); -1 on empty input."""
    vals = list(vals)
    if not vals:
        return -1
    mn, mx = min(vals), max(vals)
    if mn == mx:
        return mn
    hist = {}
    peakval, peakfreq = -1, -1
    for v in vals:
        hist[v] = hist.get(v, 0) + 1
        if hist[v] > peakfreq:
            peakfreq = hist[v]
            peakval = v
    return peakval


def descending(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort descending, returning (sorted, original indices)
    (toolbox.cpp:203-224 `descending`)."""
    a = np.asarray(a)
    idx = np.argsort(-a, kind="stable")
    return a[idx], idx


def get_k_highest(a: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k values and their indices, descending (toolbox.h:134 `getKhighest`)."""
    a = np.asarray(a)
    k = min(k, a.size)
    part = np.argpartition(-a, k - 1)[:k]
    order = np.argsort(-a[part], kind="stable")
    idx = part[order]
    return a[idx], idx


def probability_distribution(a: np.ndarray) -> np.ndarray:
    """Normalize to a distribution; all-(near)zero input becomes uniform
    (toolbox.cpp:226-243)."""
    a = np.asarray(a, np.float64)
    s = a.sum()
    if s <= 1e-5:
        return np.full(a.shape, 1.0 / a.size)
    return a / s
