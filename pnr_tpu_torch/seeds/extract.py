"""Seed extraction: the MaximumFinder tolerance flood and the direction decode.

Port of pnr_tpu/seeds/extract.py (parity targets seed.cpp's MaximumFinder
and the direction decode at seed.cpp:767-771). Two floods, routed as the
JAX package routes them (`seed_mask`):

* `max_points_host` — the exact sequential algorithm in the native host
  runtime (pnr_tpu_torch/native), on J8 fetched with `.cpu()`;
* `max_points_device` — JAX's parallel reformulation, priority label
  propagation, as torch ops on the stack's device: used when the native
  library is not built. Known divergence from the sequential flood on
  cascading kills (PARITY.md divergence 5): equal seed counts, >= 95% of
  positions exact, every divergent seed within 2 px; identical sets on
  smooth inputs.

The quantized Frangi directions are decoded at the seed voxels only, with
a gather on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pnr_tpu_torch import native

_OFF_BITS = 24
_OFF_MASK = (1 << _OFF_BITS) - 1
# the device flood's working set a voxel (the int64 claims, their padded
# copy, the propagation's candidate and temporaries, the kill and
# centroid scatters), and the chunk of planes it may hold at once
FLOOD_BYTES_PER_VOXEL = 64
FLOOD_BUDGET_BYTES = 4 << 30


def _shifted8(padded: torch.Tensor, h: int, w: int):
    """The 8 neighbour views of a (Z, H+2, W+2) border-padded stack."""
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                yield padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _nbmax8(x: torch.Tensor, fill) -> torch.Tensor:
    """Max over the 8 neighbours of each pixel of (Z, H, W) `x`, the
    border filled with `fill`."""
    z, h, w = x.shape
    p = x.new_full((z, h + 2, w + 2), fill)
    p[:, 1:-1, 1:-1] = x
    out = None
    for s in _shifted8(p, h, w):
        out = s.clone() if out is None else torch.maximum(out, s, out=out)
    return out


def _chunk_max_points(v8: torch.Tensor, tol: int) -> torch.Tensor:
    """MAX_POINT mask of a (Z, H, W) uint8 chunk, each slice alone
    (JAX's `_slice_max_points` over a vmap)."""
    zc, h, w = v8.shape
    hw = h * w
    dev = v8.device
    v = v8.to(torch.int32)
    gmin = v.reshape(zc, -1).amin(dim=1).view(zc, 1, 1)
    nbmax = _nbmax8(v, -1)

    yy = torch.arange(h, device=dev, dtype=torch.int32).view(1, h, 1)
    xx = torch.arange(w, device=dev, dtype=torch.int32).view(1, 1, w)
    offset = (yy * w + xx).to(torch.int64)  # (1, H, W)
    border = torch.zeros((1, h, w), dtype=torch.bool, device=dev)
    border[:, 0] = border[:, -1] = True
    border[:, :, 0] = border[:, :, -1] = True

    is_max = (v >= nbmax) & (v != gmin) & ~border
    prio = (v.to(torch.int64) << _OFF_BITS) | offset
    # claims in int64: 255 << 24 overflows int32, and uint32 has too few
    # ops on CUDA
    padded = torch.zeros((zc, h + 2, w + 2), dtype=torch.int64, device=dev)
    inner = padded[:, 1:-1, 1:-1]
    inner.copy_(torch.where(is_max, prio, 0))
    # a claim s (origin value v0 = s >> 24) may enter a pixel of value v
    # where v0 - tol <= v <= v0, i.e. lo <= s < hi
    lo = v.to(torch.int64) << _OFF_BITS
    hi = (v.to(torch.int64) + (tol + 1)) << _OFF_BITS
    best = torch.empty((zc, h, w), dtype=torch.int64, device=dev)
    below = torch.empty_like(best)

    def propagate():
        # JAX's step: each pixel takes the largest claim among its own and
        # its neighbours' that may enter it. The largest neighbour claim
        # under hi enters where it reaches lo, and no other can then (any
        # that may enter lies in [lo, hi) and is no larger); s == 0 (no
        # claim) adds nothing to the max
        below.zero_()
        for s in _shifted8(padded, h, w):
            torch.maximum(below, s.masked_fill(s >= hi, 0), out=below)
        torch.maximum(inner, below.masked_fill_(below < lo, 0), out=best)
        inner.copy_(best)

    while True:
        # 16 propagation steps a convergence check, as JAX's while_loop
        before = inner.clone()
        for _ in range(16):
            propagate()
        if not bool((inner != before).any()):
            break
    del before, best, below, lo, hi

    claim = inner.clone()
    nbmax_claim = None
    for s in _shifted8(padded, h, w):
        nbmax_claim = s.clone() if nbmax_claim is None else torch.maximum(
            nbmax_claim, s, out=nbmax_claim)
    del padded, inner
    claimed = claim > 0
    v0 = (claim >> _OFF_BITS).to(torch.int32)
    zbase = torch.arange(zc, device=dev, dtype=torch.int64).view(zc, 1, 1) * hw
    # each pixel's label as an index into the chunk's flat planes
    origin = zbase + (claim & _OFF_MASK)

    # kill rules per claimed pixel, OR-reduced per label
    bad = claimed & ((nbmax > v0) | (nbmax_claim > claim) | border)
    del nbmax, nbmax_claim
    killed = torch.zeros(zc * hw, dtype=torch.bool, device=dev)
    killed[origin[bad]] = True
    own = is_max & (claim == prio) & ~killed.view(zc, h, w)
    del bad, killed, prio, is_max

    # MAX_POINT: among the EQUAL pixels (v == v0) of each region, the one
    # nearest the EQUAL centroid; ties go to the largest offset. The
    # centroid sums are exact in int64 (JAX adds f32, exact below 2^24)
    eq = claimed & (v == v0)
    del claimed, v0, v
    idx = origin[eq]
    ex = xx.expand(zc, h, w)[eq].to(torch.int64)
    ey = yy.expand(zc, h, w)[eq].to(torch.int64)
    cnt = torch.zeros(zc * hw, dtype=torch.int64, device=dev).index_add_(
        0, idx, torch.ones_like(idx))
    sx = torch.zeros_like(cnt).index_add_(0, idx, ex)
    sy = torch.zeros_like(cnt).index_add_(0, idx, ey)
    cnt_safe = torch.clamp(cnt.to(torch.float32), min=1.0)
    cx = (sx.to(torch.float32) / cnt_safe)[idx]
    cy = (sy.to(torch.float32) / cnt_safe)[idx]
    del cnt, sx, sy, cnt_safe
    dx = ex.to(torch.float32) - cx
    dy = ey.to(torch.float32) - cy
    # XLA contracts JAX's dx**2 + dy**2 into fma(dx, dx, dy * dy), which
    # breaks the exact ties of mirrored pixels; the same fma here: dx*dx
    # is exact in float64, and the sum rounds once to float32 (but where
    # the float64 sum lands on a float32 midpoint)
    d2 = (dx.to(torch.float64) * dx.to(torch.float64) + (dy * dy).to(torch.float64)).to(torch.float32)
    min_d2 = torch.full((zc * hw,), float("inf"), dtype=torch.float32, device=dev)
    min_d2.scatter_reduce_(0, idx, d2, "amin")
    at_min = d2 == min_d2[idx]
    best_off = torch.full((zc * hw,), -1, dtype=torch.int64, device=dev)
    best_off.scatter_reduce_(0, idx[at_min], (ey * w + ex)[at_min], "amax")

    # each surviving label marks its pick
    o = (zbase + offset).expand(zc, h, w)[own]
    b = best_off[o]
    keep = b >= 0
    mask = torch.zeros(zc * hw, dtype=torch.bool, device=dev)
    mask[(o - (o % hw) + b)[keep]] = True
    return mask.view(zc, h, w)


def max_points_device(j8: torch.Tensor, tolerance: float) -> torch.Tensor:
    """Per-slice MAX_POINT mask of a (Z, Y, X) uint8 volume, as a bool
    tensor on `j8`'s device (JAX's label propagation). Slices are
    independent: the stack floods in chunks of as many planes as
    `FLOOD_BUDGET_BYTES` holds, bitwise the same for any chunking."""
    if j8.dtype != torch.uint8 or j8.dim() != 3:
        raise ValueError(f"max_points_device wants a (Z, Y, X) uint8 tensor, got {j8.dtype} {tuple(j8.shape)}")
    l, h, w = j8.shape
    if h * w >= (1 << _OFF_BITS):
        raise ValueError("slice too large for 24-bit offset packing")
    tol = int(tolerance)
    out = torch.zeros((l, h, w), dtype=torch.bool, device=j8.device)
    if out.numel() == 0:
        return out
    max_planes = max(1, FLOOD_BUDGET_BYTES // (FLOOD_BYTES_PER_VOXEL * h * w))
    for z0 in range(0, l, max_planes):
        z1 = min(l, z0 + max_planes)
        out[z0:z1] = _chunk_max_points(j8[z0:z1], tol)
    return out


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


def seed_mask(j8: torch.Tensor, tolerance: float, j8_np: Optional[np.ndarray] = None) -> np.ndarray:
    """The seed flood, routed as the JAX package routes it: the native
    host flood when the library is built (on `j8_np`, the host copy of
    `j8`, when the caller has one), else `max_points_device` on the
    device that holds `j8`. Returns the host bool mask."""
    if native.have_native():
        return max_points_host(j8.cpu().numpy() if j8_np is None else j8_np, float(tolerance))
    return max_points_device(j8, float(tolerance)).cpu().numpy()


def decode_directions(
    vx_u8: np.ndarray, vy_u8: np.ndarray, vz_u8: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode quantized Frangi directions to normalized floats (seed.cpp:767-771)."""
    ux = (vx_u8.astype(np.float32) / 255.0) * 2.0 - 1.0
    uy = (vy_u8.astype(np.float32) / 255.0) * 2.0 - 1.0
    uz = (vz_u8.astype(np.float32) / 255.0) * 2.0 - 1.0
    un = np.sqrt(ux * ux + uy * uy + uz * uz)
    un = np.where(un > 0, un, 1.0)
    return ux / un, uy / un, uz / un


def extract_seeds(
    j8,
    vx_u8,
    vy_u8,
    vz_u8,
    tolerance: float,
    use_device: bool = True,
    device="cuda",
):
    """Full seed extraction: positions + decoded directions.

    Returns (pos (N, 3) float32 in (x, y, z) order, dirs (N, 3) float32),
    ordered by slice-major scan of the MAX_POINT mask. `use_device` floods
    with `max_points_device` on `device` (a tensor `j8` floods on its
    own device), else with the native host flood."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    if use_device:
        t = j8 if isinstance(j8, torch.Tensor) else torch.from_numpy(np.asarray(j8)).to(device)
        mask = max_points_device(t, float(tolerance)).cpu().numpy()
    else:
        mask = max_points_host(host(j8), float(tolerance))
    zz, yy, xx = np.nonzero(mask)
    pos = np.stack([xx, yy, zz], axis=-1).astype(np.float32)
    ux, uy, uz = decode_directions(host(vx_u8)[zz, yy, xx], host(vy_u8)[zz, yy, xx],
                                   host(vz_u8)[zz, yy, xx])
    dirs = np.stack([ux, uy, uz], axis=-1).astype(np.float32)
    return pos, dirs


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
