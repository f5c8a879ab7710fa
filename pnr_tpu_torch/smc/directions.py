"""Uniform unit-direction codebooks.

Parity target: `Tracker::generate_directions`
(pnr-vaa3d/tracker.cpp:770-805) — 2-D: 30 points on the circle with
angle step 2*3.14/n (the reference's truncated pi, kept verbatim);
3-D: 50 points on a Saff–Kuijlaars-style spherical spiral with
h_k = 1 - 2k/(n-1). `nearest_direction` is `Tracker::getdirection`'s
lookup as torch ops (the tracer inlines its own argmax).
"""

from __future__ import annotations

import math

import numpy as np
import torch

NDIRS_2D = 30
NDIRS_3D = 50


def generate_directions(is2d: bool, ndirs: int | None = None) -> np.ndarray:
    """(N, 3) float32 codebook of unit directions."""
    n = ndirs if ndirs is not None else (NDIRS_2D if is2d else NDIRS_3D)
    out = np.zeros((n, 3), np.float32)
    if is2d:
        for k in range(n):
            ang = k * ((2.0 * 3.14) / n)
            out[k] = (math.cos(ang), math.sin(ang), 0.0)
    else:
        phi_prev = 0.0
        for k in range(n):
            h_k = 1.0 - 2.0 * (k / (n - 1.0))
            theta = math.acos(h_k)
            if k == 0 or k == n - 1:
                phi = 0.0
                phi_prev = 0.0
            else:
                phi = phi_prev + 3.6 / (math.sqrt(n) * math.sqrt(1.0 - h_k * h_k))
                phi_prev = phi
            out[k] = (
                math.sin(theta) * math.cos(phi),
                math.sin(theta) * math.sin(phi),
                math.cos(theta),
            )
    return out


def sphere_directions_frangi(ndirs: int) -> np.ndarray:
    """Frangi-class codebook variant with h_k = -1..1 (frangi.cpp:60-90)."""
    out = np.zeros((ndirs, 3), np.float32)
    phi_prev = 0.0
    for k in range(ndirs):
        h_k = -1.0 + 2.0 * k / (ndirs - 1.0)
        theta = math.acos(h_k)
        if k == 0 or k == ndirs - 1:
            phi = 0.0
            phi_prev = 0.0
        else:
            phi = phi_prev + 3.6 / (math.sqrt(ndirs) * math.sqrt(1.0 - h_k * h_k))
            phi_prev = phi
        out[k] = (
            math.sin(theta) * math.cos(phi),
            math.sin(theta) * math.sin(phi),
            math.cos(theta),
        )
    return out


def nearest_direction(dirs, codebook):
    """Index of the codebook direction with max dot product (first max wins).

    dirs: (..., 3); codebook: (N, 3). Returns (...,) int32. The dots are
    float32 multiply-adds, so no TF32 matmul setting can change a near tie."""
    d = torch.as_tensor(dirs, dtype=torch.float32)
    c = torch.as_tensor(codebook, dtype=torch.float32, device=d.device)
    dots = d[..., None, 0] * c[:, 0] + d[..., None, 1] * c[:, 1] + d[..., None, 2] * c[:, 2]
    return dots.argmax(dim=-1).to(torch.int32)
