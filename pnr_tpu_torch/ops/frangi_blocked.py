"""Tiled and Z-blocked Frangi for stacks whose working set exceeds the card.

Port of pnr_tpu/ops/frangi_blocked.py (`frangi_halo_z`, `frangi_halo_y`,
`pick_blocks`, `frangi3d_tiled`, `frangi3d_blocked`, `pick_blocks_2d`,
`frangi2d_tiled`). Each 3-D engine runs the
unfused `frangi3d` (ops/frangi.py: K4 and K3 on a card, the plain chain
on the CPU) on overlapping tiles, so peak memory is the outputs plus one
tile's working set, and returns what `frangi3d` returns on the whole
volume, bit for bit: the halo covers the stencil's reach, and the
kernels compute each voxel by one code path wherever a tile starts.

Where JAX carries the outputs through a `fori_loop` (`frangi3d_tiled`)
or stacks `lax.map` tiles (`frangi3d_blocked`), the port runs a Python
loop over the tiles and writes each kept block in place into outputs
allocated once; Jmin and Jmax stay 0-d tensors on the device.
`frangi2d_tiled` does the same for the 2-D filter (`frangi2d`) on a
(Y, X) image tiled along both axes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pnr_tpu_torch.ops.frangi import frangi2d, frangi3d


def frangi_halo_z(sigmas, zdist) -> int:
    return int(math.ceil(3.0 * max(sigmas) / zdist)) + 2


def frangi_halo_y(sigmas) -> int:
    #: xy Gaussian reach (ceil(3*sigma) half-width) + the two chained
    #: central-difference taps of the Hessian
    return int(math.ceil(3.0 * max(sigmas))) + 2


def pick_blocks(
    shape: Tuple[int, int, int],
    sigmas: Tuple[float, ...],
    zdist: float,
    tile_vox_budget: int = 32 * 1024 * 1024,
):
    """(block_z, block_y) for `frangi3d_tiled` so one tile's working set
    stays near `tile_vox_budget` voxels, preferring large Y tiles (less
    halo re-compute). Returns None only when even a minimal (1, 8) tile
    exceeds the budget (absurdly wide X — caller falls back). The budget
    is JAX's, sized for a 16-GiB chip."""
    z, y, x = shape
    hz, hy = frangi_halo_z(sigmas, zdist), frangi_halo_y(sigmas)
    by_max = tile_vox_budget // ((min(z, 32) + 2 * hz) * x) - 2 * hy
    by = min(y, max(8, by_max // 8 * 8))
    bz_max = tile_vox_budget // ((min(by, y) + 2 * hy) * x) - 2 * hz
    bz = min(z, max(1, bz_max))
    if (min(bz, z) + 2 * hz) * (min(by, y) + 2 * hy) * x > tile_vox_budget * 1.5:
        return None
    return bz, by


def pick_blocks_2d(
    shape_yx: Tuple[int, int],
    sigmas: Tuple[float, ...],
    tile_pix_budget: int = 32 * 1024 * 1024,
):
    """(block_y, block_x) for `frangi2d_tiled` with a ~32-Mpix tile (JAX's
    budget)."""
    h = frangi_halo_y(sigmas)
    y, x = shape_yx
    side = max(256, int(tile_pix_budget**0.5) - 2 * h)
    by = min(y, side)
    bx = min(x, max(256, tile_pix_budget // (by + 2 * h) - 2 * h))
    return by, bx


def frangi2d_tiled(
    img: torch.Tensor,
    sigmas: Tuple[float, ...],
    beta_one: float = 0.5,
    beta_two: float = 15.0,
    block_y: int = 4096,
    block_x: int = 4096,
    jmin_rows: Optional[Tuple[int, int]] = None,
):
    """2-axis tiled 2-D Frangi over a (Y, X) image, bitwise `frangi2d`
    (borders included), with O(outputs + tile) peak memory: the aligned
    windows of `frangi3d_tiled` along y and x (halo `frangi_halo_y`).
    Returns (J, Jmin, Jmax, Vx, Vy); the caller adds the zero Vz.
    `jmin_rows` (lo, hi) restricts Jmin to those rows (a shard's own rows
    of its halo slab, parallel/sharded.py)."""
    y, x = img.shape
    h = frangi_halo_y(sigmas)
    by, bx = min(block_y, y), min(block_x, x)
    wy, wx = min(by + 2 * h, y), min(bx + 2 * h, x)
    ny, nx = -(-y // by), -(-x // bx)
    if ny * nx == 1 and jmin_rows is None:
        return frangi2d(img, sigmas, beta_one, beta_two)[:5]

    j, jmin, jmax, vx, vy, _ = _outputs((y, x), img.device)
    for i in range(ny * nx):
        iy, ix = divmod(i, nx)
        y0 = min(iy * by, y - by)
        x0 = min(ix * bx, x - bx)
        sy = min(max(y0 - h, 0), y - wy)
        sx = min(max(x0 - h, 0), x - wx)
        tile = img[sy : sy + wy, sx : sx + wx].contiguous()
        jt, _, _, vxt, vyt, _, v1 = frangi2d(tile, sigmas, beta_one, beta_two,
                                             keep_first_scale=True)
        keep = (slice(y0 - sy, y0 - sy + by), slice(x0 - sx, x0 - sx + bx))
        out = (slice(y0, y0 + by), slice(x0, x0 + bx))
        jc = jt[keep]
        j[out] = jc
        # Jmin reduces the first-scale response over the kept block, which
        # is bitwise the monolithic first-scale response there
        jmin = _min_rows(jmin, v1[keep], y0, jmin_rows)
        jmax = torch.maximum(jmax, jc.max())
        vx[out], vy[out] = vxt[keep], vyt[keep]
    return j, jmin, jmax, vx, vy


def _min_rows(jmin, v1, r0: int, rows):
    """jmin folded with the min of `v1`, whose row 0 is row r0, over the
    rows in `rows` = (lo, hi) (all of them when None)."""
    if rows is None:
        return torch.minimum(jmin, v1.min())
    a, b = max(r0, rows[0]) - r0, min(r0 + v1.shape[0], rows[1]) - r0
    return torch.minimum(jmin, v1[a:b].min()) if a < b else jmin


def _outputs(shape, device):
    j = torch.zeros(shape, dtype=torch.float32, device=device)
    vx, vy, vz = (torch.zeros(shape, dtype=torch.uint8, device=device) for _ in range(3))
    inf = torch.tensor(float("inf"), device=device)
    return j, inf, -inf, vx, vy, vz


def frangi3d_tiled(
    vol: torch.Tensor,
    sigmas: Tuple[float, ...],
    zdist: float,
    alpha: float = 0.5,
    beta: float = 0.5,
    c: float = 500.0,
    block_z: int = 16,
    block_y: int = 256,
    jmin_rows: Optional[Tuple[int, int]] = None,
):
    """2-axis tiled Frangi, bitwise `frangi3d` (borders included), with
    O(outputs + tile) peak memory. `jmin_rows` (lo, hi) restricts Jmin to
    those planes (a shard's own planes of its halo slab,
    parallel/sharded.py).

    Aligned-window tiling, as in JAX: each tile's fetch window is shifted
    to stay inside the volume, so a window edge coincides with the true
    volume border exactly when the kept region is close enough to be
    affected; the one-sided border differences then fire at true borders
    and nowhere else, and interior voxels see a full stencil halo of real
    data. Tail tiles clamp their kept start (z0 = min(i*bz, z-bz)),
    recomputing a few overlap rows with identical values."""
    z, y, x = vol.shape
    hz = frangi_halo_z(sigmas, zdist)
    hy = frangi_halo_y(sigmas)
    bz, by = min(block_z, z), min(block_y, y)
    wz = min(bz + 2 * hz, z)
    wy = min(by + 2 * hy, y)
    nz, ny = -(-z // bz), -(-y // by)
    if nz * ny == 1 and jmin_rows is None:
        return frangi3d(vol, sigmas, zdist, alpha, beta, c)

    j, jmin, jmax, vx, vy, vz = _outputs((z, y, x), vol.device)
    for i in range(nz * ny):
        iz, iy = divmod(i, ny)
        z0 = min(iz * bz, z - bz)
        y0 = min(iy * by, y - by)
        sz = min(max(z0 - hz, 0), z - wz)
        sy = min(max(y0 - hy, 0), y - wy)
        tile = vol[sz : sz + wz, sy : sy + wy].contiguous()
        jt, _, _, vxt, vyt, vzt, v1 = frangi3d(
            tile, sigmas, zdist, alpha, beta, c, keep_first_scale=True
        )
        keep = (slice(z0 - sz, z0 - sz + bz), slice(y0 - sy, y0 - sy + by))
        out = (slice(z0, z0 + bz), slice(y0, y0 + by))
        jc = jt[keep]
        j[out] = jc
        # Jmin reduces the FIRST-scale response over the kept block
        # (reference running-min semantics): the kept region's v1 is
        # bitwise the monolithic first-scale response
        jmin = _min_rows(jmin, v1[keep], z0, jmin_rows)
        jmax = torch.maximum(jmax, jc.max())
        vx[out], vy[out], vz[out] = vxt[keep], vyt[keep], vzt[keep]
    return j, jmin, jmax, vx, vy, vz


def frangi3d_blocked(
    vol: torch.Tensor,
    sigmas: Tuple[float, ...],
    zdist: float,
    alpha: float = 0.5,
    beta: float = 0.5,
    c: float = 500.0,
    block_z: int = 32,
    jmin_rows: Optional[Tuple[int, int]] = None,
):
    """Same contract as `frangi3d`, O(block) peak memory: Z tiles of
    `block_z` planes with an edge-replicated halo, then the two planes at
    each true border recomputed on thin slabs whose edge is that border.
    `jmin_rows` as in `frangi3d_tiled`."""
    z, y, x = vol.shape
    halo = frangi_halo_z(sigmas, zdist)
    if z <= 2 * (halo + 4) and jmin_rows is not None:
        j, _, _, vx, vy, vz, v1 = frangi3d(vol, sigmas, zdist, alpha, beta, c,
                                           keep_first_scale=True)
        jmin = _min_rows(torch.tensor(float("inf"), device=vol.device), v1, 0, jmin_rows)
        return j, jmin, j.max(), vx, vy, vz
    if z <= 2 * (halo + 4):
        # too shallow to both tile and keep exact true borders — and by
        # construction small enough for the monolithic path
        return frangi3d(vol, sigmas, zdist, alpha, beta, c)
    nblk = -(-z // block_z)

    j, jmin, jmax, vx, vy, vz = _outputs((z, y, x), vol.device)
    for i in range(nblk):
        z0 = i * block_z
        # the edge-padded volume's planes [z0, z0 + block_z + 2 halo)
        idx = torch.arange(z0 - halo, z0 + block_z + halo, device=vol.device).clamp_(0, z - 1)
        jt, _, _, vxt, vyt, vzt, v1 = frangi3d(
            vol.index_select(0, idx), sigmas, zdist, alpha, beta, c, keep_first_scale=True
        )
        n = min(block_z, z - z0)
        sl = slice(halo, halo + n)
        out = slice(z0, z0 + n)
        jc = jt[sl]
        j[out] = jc
        vx[out], vy[out], vz[out] = vxt[sl], vyt[sl], vzt[sl]
        # Jmin (first-scale response) and Jmax over the kept planes, less
        # the 2 planes at each true border: inside a tile the padded halo
        # turns the one-sided border difference into central/2 there, so
        # they are recomputed below and folded in there
        lo, hi = max(z0, 2) - z0, min(z0 + n, z - 2) - z0
        if hi > lo:
            jmin = _min_rows(jmin, v1[halo + lo : halo + hi], z0 + lo, jmin_rows)
            jmax = torch.maximum(jmax, jc[lo:hi].max())

    # True-border fix: slabs deep enough that their far edge cannot reach
    # the kept planes, so the result is bitwise `frangi3d`
    fix = halo + 4
    jh, _, _, vxh, vyh, vzh, v1h = frangi3d(
        vol[:fix], sigmas, zdist, alpha, beta, c, keep_first_scale=True
    )
    jt, _, _, vxt, vyt, vzt, v1t = frangi3d(
        vol[z - fix :], sigmas, zdist, alpha, beta, c, keep_first_scale=True
    )
    j[:2], j[z - 2 :] = jh[:2], jt[-2:]
    vx[:2], vx[z - 2 :] = vxh[:2], vxt[-2:]
    vy[:2], vy[z - 2 :] = vyh[:2], vyt[-2:]
    vz[:2], vz[z - 2 :] = vzh[:2], vzt[-2:]
    jmin = _min_rows(_min_rows(jmin, v1h[:2], 0, jmin_rows), v1t[-2:], z - 2, jmin_rows)
    jmax = torch.maximum(jmax, torch.maximum(jh[:2].max(), jt[-2:].max()))
    return j, jmin, jmax, vx, vy, vz
