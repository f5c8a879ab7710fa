"""Histogram thresholding: max-entropy (Kapur), Otsu, intermodes.

Port of pnr_tpu/ops/thresholds.py (parity targets `maxentropy_th`,
pnr-vaa3d/toolbox.cpp:657-737, the live path of the soma stage;
`otsu_th`, :596-655; `intermodes_th`, :528-594). The 256-bin histogram
is counted on the image's device; the 256-entry searches keep JAX's
float32 arithmetic and its order (the normalised histogram, the
cumulative sums, the `where` guards at FLT_MIN, the first maximum), on
the host; intermodes' data-dependent smoothing loop runs there in
float64, as in JAX. None of this is a TPU kernel.

The cumulative sums are added in the order XLA adds them on the CPU
(`_cumsum256`), not sequentially: Otsu's `omega != 1.0` test sees the
difference in the last place. The histogram's total is exact in any
order up to 2^24 counts; above that JAX's order is not reproduced.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

_FLT_MIN = 1.175494e-38


def histogram256(img: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of a uint8 tensor (int32 counts)."""
    return torch.bincount(img.reshape(-1).to(torch.int64), minlength=256).to(torch.int32)


def _as_hist(img_or_hist: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
    """The float32 histogram on the host."""
    arr = torch.as_tensor(img_or_hist)
    if tuple(arr.shape) != (256,):
        arr = histogram256(arr)
    return arr.to(device="cpu", dtype=torch.float32)


def _cumsum256(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums of 256 values in XLA's CPU order
    (its reduce-window rewrite for a cumulative sum, base 16): sequential
    sums within each block of 16, sequential sums of the block totals,
    and each block's values added to the total of the blocks before it."""
    w = x.reshape(16, 16).clone()
    for j in range(1, 16):
        w[:, j] += w[:, j - 1]
    tot = w[:, 15].clone()
    for b in range(1, 16):
        tot[b] += tot[b - 1]
    w[1:] += tot[:-1, None]
    return w.reshape(256)


def _guarded(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """where(den > FLT_MIN, -num / max(den, FLT_MIN) + log(max(den, FLT_MIN)), 0)."""
    d = torch.clamp(den, min=_FLT_MIN)
    return torch.where(den > _FLT_MIN, -num / d + torch.log(d), torch.zeros_like(den))


def _maxentropy_from_hist(hist: torch.Tensor) -> int:
    p = hist / torch.sum(hist)
    pt = _cumsum256(p)
    plogp = torch.where(p > _FLT_MIN, p * torch.log(torch.clamp(p, min=_FLT_MIN)),
                        torch.zeros_like(p))
    cum_plogp = _cumsum256(plogp)
    # black entropy over [0..t]: -(1/pT) sum plogp + log pT; white over the rest
    hb = _guarded(cum_plogp, pt)
    hw = _guarded(cum_plogp[-1] - cum_plogp, 1.0 - pt)
    return int(torch.argmax(hb + hw))


def maxentropy_th(img_or_hist) -> int:
    """Kapur max-entropy threshold of a uint8 image (or 256-bin histogram)."""
    return _maxentropy_from_hist(_as_hist(img_or_hist))


def _otsu_from_hist(hist: torch.Tensor) -> int:
    prob = hist / torch.sum(hist)
    omega = _cumsum256(prob)
    levels = torch.arange(256, dtype=torch.float32)
    myu = _cumsum256(levels * prob)
    valid = (omega != 0.0) & (omega != 1.0)
    sigma = torch.where(
        valid,
        (myu[-1] * omega - myu) ** 2 / torch.clamp(omega * (1.0 - omega), min=_FLT_MIN),
        torch.zeros_like(omega),
    )
    # the reference scans t in [0, 254] keeping strictly-greater (first max wins)
    sigma[255] = 0.0
    best = int(torch.argmax(sigma))
    return best if float(sigma[best]) > 0.0 else 0


def otsu_th(img_or_hist) -> int:
    """Otsu inter-class-variance threshold (toolbox.cpp:596-655)."""
    return _otsu_from_hist(_as_hist(img_or_hist))


def _bimodal(y: np.ndarray) -> bool:
    modes = 0
    for k in range(1, len(y) - 1):
        if y[k - 1] < y[k] and y[k + 1] < y[k]:
            modes += 1
            if modes > 2:
                return False
    return modes == 2


def intermodes_th(img_or_hist) -> int:
    """Intermodes threshold: smooth histogram until bimodal, mean of the peaks.

    Returns -1 if no bimodal form after 10000 iterations (toolbox.cpp:574-578).
    """
    hist = _as_hist(img_or_hist).numpy()
    nz = np.nonzero(hist > 0)[0]
    if nz.size == 0:
        return -1
    minbin, maxbin = int(nz[0]), int(nz[-1])
    h = hist[minbin : maxbin + 1].astype(np.float64)
    it = 0
    while not _bimodal(h):
        # 3-point running mean over the original values; the first bin sees a
        # zero left neighbour and the last bin averages only two terms,
        # matching the reference's rolling stencil (toolbox.cpp:563-572).
        prev = np.concatenate(([0.0], h[:-1]))
        nxt = np.concatenate((h[1:], [0.0]))
        sm = (prev + h + nxt) / 3.0
        sm[-1] = (h[-2] + h[-1]) / 3.0 if len(h) > 1 else h[-1] / 3.0
        h = sm
        it += 1
        if it > 10000:
            return -1
    peaks = [i for i in range(1, len(h) - 1) if h[i - 1] < h[i] and h[i + 1] < h[i]]
    return int(np.floor(sum(peaks) / 2.0)) + minbin
