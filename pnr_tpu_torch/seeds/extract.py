"""Seed extraction: MaximumFinder flood on the host, directions on device.

Port of the single-stack pieces of pnr_tpu/seeds/extract.py
(`max_points_host`, `decode_directions_device`; parity targets
seed.cpp's MaximumFinder and the direction decode at seed.cpp:767-771).
The flood runs in the native host runtime (pnr_tpu_torch/native) on the J8 volume fetched
with `.cpu()`; the quantized Frangi directions are decoded at the seed
voxels only, with a gather on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pnr_tpu_torch import native


def max_points_host(j8: np.ndarray, tolerance: float) -> np.ndarray:
    """Exact per-slice maxima of a (Z, Y, X) uint8 volume; bool mask."""
    j8 = np.asarray(j8)
    mask = native.max_finder_stack(j8, float(tolerance))
    if mask is not None:
        return mask
    mask = np.zeros(j8.shape, bool)
    for z in range(j8.shape[0]):
        pts = native.max_finder_2d(j8[z], tolerance)
        if len(pts):
            mask[z, pts[:, 1], pts[:, 0]] = True
    return mask


def decode_directions_device(
    vx_u8: torch.Tensor, vy_u8: torch.Tensor, vz_u8: torch.Tensor, pos: np.ndarray
) -> np.ndarray:
    """Decode the quantized directions at seed voxels `pos` (N, 3) xyz:
    u = v/255*2-1, normalized where |u| > 0. Returns (N, 3) float32."""
    if len(pos) == 0:
        return np.zeros((0, 3), np.float32)
    _, h, w = vx_u8.shape
    p = np.asarray(pos).astype(np.int64)
    flat = torch.from_numpy(p[:, 2] * h * w + p[:, 1] * w + p[:, 0]).to(vx_u8.device)
    u = torch.stack(
        [vx_u8.reshape(-1)[flat], vy_u8.reshape(-1)[flat], vz_u8.reshape(-1)[flat]],
        dim=-1,
    ).to(torch.float32)
    u = (u / 255.0) * 2.0 - 1.0
    n = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    u = u / torch.where(n > 0, n, torch.ones_like(n))
    return u.cpu().numpy()
