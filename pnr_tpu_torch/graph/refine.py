"""Non-blurring mean-shift node refinement on the device.

Port of the device branch of pnr_tpu/graph/refine.py `non_blurring`
(parity target Advantra_plugin.cpp:968-1052): per-node mean shift over
the ORIGINAL node positions with radius SIG2RADIUS * current sigma,
iterated up to `max_iter` times or until move^2 <= eps2, evaluated in
lockstep as blocked pairwise distances (|c|^2 + |p|^2 - 2cp, float32 —
TF32 would collapse nodes, see `require_cuda`) and masked means as a
mask @ P matmul. Above REFINE_GRID_CUTOVER nodes the shared native grid
engine takes over, as in the JAX package. `interpolate_nodelist` and
`group1` are shared with pnr_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from pnr_tpu import native
from pnr_tpu.graph.nodes import NodeList
from pnr_tpu.graph.refine import REFINE_GRID_CUTOVER

_BLOCK = 2048


def _mean_shift(p4: torch.Tensor, sig2rad: float, max_iter: int, eps2: float) -> torch.Tensor:
    """Lockstep non-blurring mean shift of (N, 4) rows (x, y, z, sig)."""
    n = p4.shape[0]
    pts = p4[:, :3]
    pts_norm2 = (pts * pts).sum(dim=1)
    conv = p4.clone()
    active = torch.ones(n, dtype=torch.bool, device=p4.device)
    for _ in range(int(max_iter)):
        if not bool(active.any()):
            break
        nxt = torch.empty_like(conv)
        for beg in range(0, n, _BLOCK):
            c_blk = conv[beg : beg + _BLOCK]
            cxyz = c_blk[:, :3]
            r2 = (sig2rad * c_blk[:, 3]) ** 2
            d2 = (cxyz * cxyz).sum(dim=1)[:, None] + pts_norm2[None, :] - 2.0 * (cxyz @ pts.T)
            mask = (d2 <= r2[:, None]).to(torch.float32)
            cnt0 = mask.sum(dim=1)
            blk = (mask @ p4) / torch.clamp(cnt0, min=1.0)[:, None]
            # a node always covers itself: an empty mask can only be
            # cancellation in the expansion — hold position
            nxt[beg : beg + _BLOCK] = torch.where(cnt0[:, None] > 0.0, blk, c_blk)
        move2 = ((nxt[:, :3] - conv[:, :3]) ** 2).sum(dim=1)
        conv = torch.where(active[:, None], nxt, conv)
        active = active & (move2 > eps2)
    return conv


def non_blurring(
    nodes: NodeList, sig2rad: float, max_iter: int, eps2: float, device
) -> NodeList:
    """Mean-shift refine all nodes (incl. soma, as the live reference does)."""
    out = nodes.copy()
    n = len(nodes)
    if n <= 1:
        return out
    p4 = np.stack(
        [
            np.asarray(nodes.x[1:], np.float32),
            np.asarray(nodes.y[1:], np.float32),
            np.asarray(nodes.z[1:], np.float32),
            np.asarray(nodes.sig[1:], np.float32),
        ],
        axis=-1,
    )
    conv = None
    if n - 1 > REFINE_GRID_CUTOVER and native.have_native():
        conv = native.mean_shift_grid(p4, float(sig2rad), int(max_iter), float(eps2))
    if conv is None:
        # centre the cloud before the distance expansion: at coordinates
        # of a few thousand, ulp(|p|^2) rivals the kernel radius^2
        centroid = p4[:, :3].mean(axis=0, dtype=np.float64).astype(np.float32)
        p4[:, :3] -= centroid
        conv = _mean_shift(
            torch.from_numpy(p4).to(device), float(sig2rad), int(max_iter), float(eps2)
        ).cpu().numpy()
        conv[:, :3] += centroid
    out.x[1:] = conv[:, 0].astype(float).tolist()
    out.y[1:] = conv[:, 1].astype(float).tolist()
    out.z[1:] = conv[:, 2].astype(float).tolist()
    out.sig[1:] = conv[:, 3].astype(float).tolist()
    return out
