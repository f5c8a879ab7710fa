"""Separable grayscale morphology (erosion / dilation).

Port of pnr_tpu/ops/morphology.py (parity targets `Frangi::imerode`,
pnr-vaa3d/frangi.cpp:879-1108, and `Frangi::imdilate`, :1110-1199): 1-D
min/max filters of half-width ceil(rad) along x and y (and
ceil(rad/zdist) along z for the xyz variant) with clamped borders.

A min/max over a clamped-index window is the min/max over the in-range
part of the window, which is what JAX's `lax.reduce_window` with
identity padding computes. Here the window is a strided view
(`Tensor.unfold`) of the edge-replicated volume, reduced with
`amin`/`amax` in the input's own dtype, so the result is exact on uint8
and on float, on any device. This is not a TPU kernel in the JAX
package, and it has no CUDA kernel here.
"""

from __future__ import annotations

import math

import torch


def _window_reduce(vol: torch.Tensor, half: int, axis: int, op: str) -> torch.Tensor:
    n = vol.shape[axis]
    idx = torch.arange(-half, n + half, device=vol.device).clamp_(0, n - 1)
    win = vol.index_select(axis, idx).unfold(axis, 2 * half + 1, 1)
    return win.amin(dim=-1) if op == "min" else win.amax(dim=-1)


def imerode_xy(vol: torch.Tensor, rad: float) -> torch.Tensor:
    """Per-slice xy erosion of a (Z, Y, X) volume (frangi.cpp:879-969)."""
    half = int(math.ceil(rad))
    v = _window_reduce(vol, half, 2, "min")
    return _window_reduce(v, half, 1, "min")


def imerode_xyz(vol: torch.Tensor, rad: float, zdist: float) -> torch.Tensor:
    """3-D erosion with z radius scaled by 1/zdist (frangi.cpp:971-1108)."""
    half = int(math.ceil(rad))
    v = _window_reduce(vol, half, 2, "min")
    v = _window_reduce(v, half, 1, "min")
    if vol.shape[0] > 1:
        v = _window_reduce(v, int(math.ceil(rad / zdist)), 0, "min")
    return v


def imdilate_xy(vol: torch.Tensor, rad: float) -> torch.Tensor:
    """Per-slice xy dilation of a (Z, Y, X) volume (frangi.cpp:1110-1199)."""
    half = int(math.ceil(rad))
    v = _window_reduce(vol, half, 2, "max")
    return _window_reduce(v, half, 1, "max")
