"""Particle mean-shift clustering for cluster-aware resampling.

Port of pnr_tpu/smc/clustering.py (parity target
`Tracker::ms/clustering/extract/runOne`, pnr-vaa3d/tracker.cpp:1604-1774):
fully implemented in the reference but its call site is commented out
(component 34, SURVEY.md §2), so no pipeline calls it; an optional,
batched building block:

* `mean_shift`: every particle converges to the local mean of the
  ORIGINAL particle positions within a flat kernel of radius krad;
* `cluster_labels`: connected components of the converged points under
  a distance threshold (label propagation);
* `largest_cluster`: particle indices of the biggest cluster and the
  cumulative sum of their weights (the reference's `extract`; NumPy,
  a copy of the JAX package's).

JAX's kernel mean is a `Precision.HIGHEST` matmul; here it is a masked
float32 sum, so no TF32 matmul setting can change it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) squared distances of (N, 3) and (M, 3) points, float32."""
    d = a[:, None, :] - b[None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def mean_shift(pts, krad: float, max_iter: int = 50, eps2: float = 1e-9) -> torch.Tensor:
    """Flat-kernel mean shift of (N, 3) points over their own support, on
    the points' device (a host array runs on the CPU)."""
    support = torch.as_tensor(pts, dtype=torch.float32)
    conv = support.clone()
    active = torch.ones(support.shape[0], dtype=torch.bool, device=support.device)
    k2 = float(krad) * float(krad)
    it = 0
    while it < max_iter and bool(active.any()):
        m = (_sqdist(conv, support) <= k2).to(torch.float32)
        cnt = torch.clamp(m.sum(dim=1), min=1.0)
        nxt = (m[:, :, None] * support[None, :, :]).sum(dim=1) / cnt[:, None]
        d = nxt - conv
        move2 = (d * d).sum(dim=1)
        conv = torch.where(active[:, None], nxt, conv)
        active = active & (move2 > eps2)
        it += 1
    return conv


def cluster_labels(conv, dist: float) -> torch.Tensor:
    """Connected-component labels (int32) of converged points within
    `dist`: iterated min-label propagation over the adjacency (the
    parallel equivalent of the reference's sequential relabeling loop)."""
    conv = torch.as_tensor(conv, dtype=torch.float32)
    n = conv.shape[0]
    adj = _sqdist(conv, conv) < float(dist) * float(dist)  # includes self
    lab = torch.arange(n, dtype=torch.int32, device=conv.device)
    big = torch.full((n, n), n, dtype=torch.int32, device=conv.device)
    while True:
        new = torch.where(adj, lab[None, :], big).amin(dim=1)
        if torch.equal(new, lab):
            return lab
        lab = new


def largest_cluster(labels: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of the largest cluster + cumulative weight sums
    (Tracker::extract, tracker.cpp:1604-1650)."""
    labels = np.asarray(labels)
    weights = np.asarray(weights)
    vals, counts = np.unique(labels, return_counts=True)
    best = vals[np.argmax(counts)]
    idx = np.nonzero(labels == best)[0]
    csw = np.cumsum(weights[idx])
    return idx, csw
