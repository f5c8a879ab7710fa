"""K1: multi-scale Frangi as a hand-written CUDA kernel (csrc/frangi_fused.cu).

Port of pnr_tpu/ops/frangi_fused.py (`frangi3d_fused`, whose Pallas
`_kernel` is the TPU kernel replaced). Same contract as `frangi3d`:
(J, Jmin, Jmax, Vx, Vy, Vz). A CPU tensor runs the plain PyTorch chain
(`frangi3d_plain`, ops/frangi.py); a CUDA tensor runs the kernel or raises.

The CUDA route makes one launch per sigma: one block per (y tile, x tile)
column of the stack walks z, keeps the uint8 planes it reads, the last
2hz + 1 xy-smoothed planes and the last 5 planes of the smoothed volume F
in shared memory, and writes only J and the three uint8 directions; then
one launch decodes (Jmin, Jmax) from the ordered-int atomics. No float32
scratch volume is allocated. `fused_plan` sizes each sigma's tile so its
rings fit one block's shared memory; `ring_schedule` is the order in which
a block fills and reads them.
"""

from __future__ import annotations

import math
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops import cuda
from pnr_tpu_torch.ops.frangi import frangi3d_plain
from pnr_tpu_torch.ops.gaussian import gaussian_kernel

#: CUDA kernel launches through the CUDA route (one per sigma, plus the
#: Jmin/Jmax decode after the last scale), so a run can show that the
#: main path went through the kernel
LAUNCHES = 0

#: a block's threads, the outputs each thread forms per tap in the x and
#: y passes, and the planes of F the Hessian reads (csrc/frangi_fused.cu)
THREADS = 1024
RUN = 4
F_RING = 5
#: the most taps the kernel takes in xy (sigma <= 21) and in z
MAX_TAPS_XY = 127
MAX_TAPS_Z = 255
#: the shared memory one block may use on the H100
SMEM_LIMIT = 232448
#: the tiles the plan weighs, each side a multiple of RUN (the last ones
#: only for the widest halos)
TILES = ((48, 48), (40, 40), (32, 32), (24, 24), (16, 32), (16, 16), (8, 16), (8, 8), (4, 8),
         (4, 4))
#: the H100's streaming multiprocessors (the plan's default)
SMS = 132


class FusedPlan(NamedTuple):
    """One sigma's launch: half-widths, tile, grid, ring depths, bytes."""

    hxy: int
    hz: int
    tile_y: int
    tile_x: int
    grid: Tuple[int, int]  # (blocks in y, blocks in x)
    ring_g: int  # xy-smoothed planes held: 2 hz + 1
    ring_f: int  # planes of F held: 5
    smem: int  # dynamic shared memory of one block, bytes


def fused_frangi_enabled() -> bool:
    """The PNR_TPU_FUSED_FRANGI switch (any value but "0", "" or "false"
    forces K1 on), read as pnr_tpu's `fused_frangi_enabled` reads it."""
    return os.environ.get("PNR_TPU_FUSED_FRANGI", "0") not in ("0", "", "false")


def half_widths(sigma: float, zdist: float) -> Tuple[int, int]:
    """(hxy, hz): the half-widths of `gaussian_kernel(sigma)` and of
    `gaussian_kernel(sigma / zdist)`."""
    return (int(math.ceil(3.0 * float(sigma))),
            int(math.ceil(3.0 * (float(sigma) / float(zdist)))))


def smem_bytes(tile_y: int, tile_x: int, hxy: int, hz: int) -> int:
    """One block's dynamic shared memory (csrc/frangi_fused.cu `Geom::smem`):
    the x-pass rows, the G and F rings (float32, xy halo 2), two uint8
    plane windows (xy halo hxy + 2; a row holds its lead below the first
    byte, for the 16-byte copies from each row's aligned chunk, and 4
    bytes the x pass reads past the window), the z pass's slot offsets
    and the warp partials of the Jmin/Jmax reduction."""
    h2 = hxy + 2
    wy, wx = tile_y + 2 * h2, tile_x + 2 * h2
    ch, cw = tile_y + 4, tile_x + 4
    pitch = (wx + 19 + 15) & ~15
    d = 2 * hz + 1
    return (4 * (wy * cw + (d + F_RING) * ch * cw) + 2 * wy * pitch + 16 * -(-d // 4)
            + 2 * (THREADS // 32) * 4)


def block_cost(tile_y: int, tile_x: int, hxy: int, hz: int) -> int:
    """A block's work per plane in issue slots, roughly: the x pass on the
    window's rows, the y and z passes on the tile with its halo of 2 (about
    2 slots per tap and output in the x and y passes, 3 in the z pass) and
    ~450 per voxel for the Hessian, eigensolve, vesselness and merge."""
    wy, ch, cw = tile_y + 2 * (hxy + 2), tile_y + 4, tile_x + 4
    nxy, nz = 2 * hxy + 1, 2 * hz + 1
    return 2 * wy * cw * nxy + 2 * ch * cw * nxy + 3 * ch * cw * nz + 450 * tile_y * tile_x


def fused_plan(shape: Sequence[int], sigma: float, zdist: float, sms: int = SMS) -> FusedPlan:
    """The tile of TILES whose block fits SMEM_LIMIT for this sigma and
    that finishes the stack soonest on `sms` SMs: the blocks the busiest SM
    takes (ceil(blocks / sms); the blocks it holds at once share its issue
    slots) times `block_cost`, the first of TILES on a tie. Raises
    ValueError with the shapes if no tile fits."""
    z, y, x = (int(s) for s in shape)
    hxy, hz = half_widths(sigma, zdist)
    if 2 * hxy + 1 > MAX_TAPS_XY or 2 * hz + 1 > MAX_TAPS_Z:
        raise ValueError(
            f"frangi3d_fused takes at most {MAX_TAPS_XY} xy and {MAX_TAPS_Z} z taps; sigma "
            f"{sigma} at zdist {zdist} needs {2 * hxy + 1} and {2 * hz + 1}")
    best = None
    for ty, tx in TILES:
        smem = smem_bytes(ty, tx, hxy, hz)
        if smem > SMEM_LIMIT:
            continue
        grid = (-(-y // ty), -(-x // tx))
        cost = -(-grid[0] * grid[1] // sms) * block_cost(ty, tx, hxy, hz)
        if best is None or cost < best[0]:
            best = (cost, FusedPlan(hxy, hz, ty, tx, grid, 2 * hz + 1, F_RING, smem))
    if best is not None:
        return best[1]
    raise ValueError(
        f"frangi3d_fused: no tile fits {SMEM_LIMIT} bytes of shared memory for a {(z, y, x)} "
        f"stack at sigma {sigma}, zdist {zdist} (hxy {hxy}, hz {hz}; the smallest tile "
        f"{TILES[-1]} needs {smem_bytes(*TILES[-1], hxy, hz)})")


class BlockWindow(NamedTuple):
    """The outputs a block owns and the clamped uint8 window it reads, as
    half-open [lo, hi) ranges of volume rows and columns."""

    out_y: Tuple[int, int]
    out_x: Tuple[int, int]
    win_y: Tuple[int, int]
    win_x: Tuple[int, int]


def block_window(plan: FusedPlan, shape: Sequence[int], by: int, bx: int) -> BlockWindow:
    """Block (by, bx)'s outputs and window, as the kernel forms them."""
    _, y, x = (int(s) for s in shape)
    y0, x0, h2 = by * plan.tile_y, bx * plan.tile_x, plan.hxy + 2
    return BlockWindow(
        (y0, min(y0 + plan.tile_y, y)), (x0, min(x0 + plan.tile_x, x)),
        (max(y0 - h2, 0), min(y0 + plan.tile_y + h2, y)),
        (max(x0 - h2, 0), min(x0 + plan.tile_x + h2, x)))


class Step(NamedTuple):
    """One step of a block's walk along z: the plane smoothed in xy into
    the G ring, the plane of F formed, the output plane finished (None
    where the step does none)."""

    g: Optional[int]
    f: Optional[int]
    out: Optional[int]


def ring_schedule(z: int, hz: int) -> List[Step]:
    """The kernel's steps k = 0 .. Z + hz + 1: G plane k (k < Z), F plane
    k - hz, output plane k - hz - 2, each where it lies in [0, Z)."""

    def inside(p):
        return p if 0 <= p < z else None

    return [Step(inside(k), inside(k - hz), inside(k - hz - 2)) for k in range(z + hz + 2)]


def frangi3d_fused(
    vol: torch.Tensor,
    sigmas: Sequence[float],
    zdist: float,
    alpha: float = 0.5,
    beta: float = 0.5,
    c: float = 500.0,
    blackwhite: bool = False,
):
    """Multi-scale Frangi of a (Z, Y, X) uint8 volume on its device."""
    if vol.device.type == "cpu":
        return frangi3d_plain(vol, sigmas, zdist, alpha, beta, c, blackwhite)
    return _frangi3d_cuda(vol, sigmas, zdist, alpha, beta, c, blackwhite)


def _frangi3d_cuda(vol, sigmas, zdist, alpha, beta, c, blackwhite):
    global LAUNCHES
    cuda.require_cuda_tensor(vol, "vol", torch.uint8, 3)
    z, y, x = (int(s) for s in vol.shape)
    if min(z, y, x) < 2:
        raise ValueError(f"frangi3d_fused needs every dimension >= 2, got {(z, y, x)}")
    if not sigmas:
        raise ValueError("frangi3d_fused needs at least one sigma")
    dev = vol.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = [fused_plan((z, y, x), s, zdist, sms) for s in sigmas]
    lib = cuda.library()
    stream = cuda.raw_stream(vol.device.index)
    j = torch.empty((z, y, x), dtype=torch.float32, device=dev)
    qx = torch.empty((z, y, x), dtype=torch.uint8, device=dev)
    qy = torch.empty_like(qx)
    qz = torch.empty_like(qx)
    # ordered-int (min, max) accumulators: 0xffffffff, 0
    stats = torch.tensor([-1, 0], dtype=torch.int32, device=dev)
    minmax = torch.empty(2, dtype=torch.float32, device=dev)
    a2 = 2.0 * float(alpha) * float(alpha)
    b2 = 2.0 * float(beta) * float(beta)
    c2 = 2.0 * float(c) * float(c)
    ns = len(sigmas)
    for si, (sig, plan) in enumerate(zip(sigmas, plans)):
        sig = float(sig)
        kxy = gaussian_kernel(sig)
        kz = gaussian_kernel(sig / float(zdist))
        cuda.check(
            lib.pnr_frangi_scale(
                vol.data_ptr(), z, y, x, plan.tile_y, plan.tile_x,
                kxy.ctypes.data, int(kxy.size), kz.ctypes.data, int(kz.size),
                float(np.float32(sig * sig)), a2, b2, c2,
                int(bool(blackwhite)), int(si == 0), int(si == ns - 1),
                j.data_ptr(), qx.data_ptr(), qy.data_ptr(), qz.data_ptr(),
                stats.data_ptr(), minmax.data_ptr(), stream,
            ),
            "pnr_frangi_scale",
        )
        with cuda.COUNT_LOCK:
            LAUNCHES += 2 if si == ns - 1 else 1
    return j, minmax[0], minmax[1], qx, qy, qz
