"""K3 and K4: the 1-D and fused y-x correlations of the unfused Frangi.

Port of pnr_tpu/ops/pallas_conv.py. `conv1d_axis` replaces
`pallas_conv1d_along_axis` (K3, Pallas `_pallas_conv`) and `conv_yx`
replaces `pallas_conv_yx` (K4, Pallas `_pallas_conv_yx`); the CUDA
kernels are in csrc/conv.cu (`conv1d_axis_cols_kernel`,
`conv1d_axis_x_kernel`, `conv_yx_kernel`).
Both take a (Z, Y, X) uint8 or float32 volume, correlate with
edge-replicated borders and return float32.

Beside each kernel is its plain PyTorch version:
* `conv1d_axis_plain`: the JAX fallback's arithmetic
  (`pallas_conv1d_along_axis`): the shift-and-add in tap order (one
  rounded product and one rounded add per tap), then, with
  `grad_border`, the first and last plane along the axis doubled
  (`jnp.gradient`'s one-sided borders from the central-difference taps);
* `conv_yx_plain`: the y pass, then the x pass, each that shift-and-add:
  the order of the TPU kernel, which JAX's own fallback (x first) does
  not keep.

A CPU tensor runs the plain version; a CUDA tensor runs the kernel or
raises. The kernels fuse each tap's multiply-add, so on the card they
differ from the plain versions by about one ulp per tap.

K3 also runs the tube map build's 1-D correlations (ops/gaussian.py
`conv1d_along_axis`, counted there): `launch_conv1d` is the one launch
both wrappers share. `conv1d_plan` is K3's launch geometry, as the C side
forms it (`pnr_conv1d_plan`), and `thread_outputs` / `thread_reads` say
which outputs a thread forms and which inputs it loads. `conv_yx_plan`
is K4's launch (`pnr_conv_yx_plan`); `yx_geom`, `yx_walk`, `yx_y_items`
and `yx_x_outputs` mirror its shared-memory layout, a block's walk down
its y tiles with the ring of staged rows, and the work of each thread,
for the CPU tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops import cuda

#: CUDA launches of K3 (`conv1d_axis`), one per call
CONV1D_LAUNCHES = 0
#: CUDA launches of K4 (`conv_yx`), one per call
CONV_YX_LAUNCHES = 0
#: the most taps a kernel takes (csrc/conv.cu kMaxTaps): sigma <= 21
MAX_TAPS = 127
#: K3's geometry (csrc/conv.cu): outputs a thread forms along z or y, a
#: column block's threads along x and along the other axis, the x outputs
#: of one warp of the x kernel and the rows (warps) of its block
RUN_COLS = 8
COLS_X = 32
COLS_O = 4
ROW_SEG = 128
ROWS = 8
#: K4's geometry (csrc/conv.cu): the x outputs of a block (a half-warp's
#: row), the y-pass rows a thread forms down its column, the x-pass
#: outputs a lane forms along its row, the warps of a block, its tile
#: heights (tallest first: the tallest whose block takes at most a
#: quarter of SMEM_LIMIT, else the last) and the shared memory a block can
#: take (ops/frangi_fused.SMEM_LIMIT too, whose module imports this one)
YX_TILE_X = 128
YX_RUN = 16
YX_LANE = 8
YX_WARPS = 8
YX_TILE_YS = (64, 32, 16)
SMEM_LIMIT = 232448
#: the blocks K4's plan aims for (~16 on each of the H100's 132 SMs): a
#: block walks as many y tiles as leaves about that many
YX_BLOCKS = 132 * 16


def _taps(kernel, name: str) -> np.ndarray:
    taps = np.ascontiguousarray(kernel, np.float32).reshape(-1)
    if taps.size % 2 == 0 or taps.size > MAX_TAPS:
        raise ValueError(f"{name} needs an odd number of taps <= {MAX_TAPS}, got {taps.size}")
    return taps


def _check_volume(vol: torch.Tensor) -> None:
    if vol.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"vol must be uint8 or float32, got {vol.dtype}")
    cuda.require_cuda_tensor(vol, "vol", vol.dtype, 3)


def conv1d_axis(vol: torch.Tensor, kernel, axis: int, grad_border: bool = False) -> torch.Tensor:
    """Correlate a (Z, Y, X) `vol` with the 1-D `kernel` along `axis`,
    edge-replicated; `grad_border` doubles the end planes. float32 out."""
    if vol.device.type == "cpu":
        return conv1d_axis_plain(vol, kernel, axis, grad_border)
    return _conv1d_axis_cuda(vol, kernel, axis, grad_border)


def _conv1d_axis_cuda(vol, kernel, axis, grad_border):
    global CONV1D_LAUNCHES
    out = launch_conv1d(vol, kernel, axis, grad_border, "conv1d_axis")
    with cuda.COUNT_LOCK:
        CONV1D_LAUNCHES += 1
    return out


def launch_conv1d(vol: torch.Tensor, kernel, axis: int, grad_border: bool, name: str):
    """One launch of K3 on a CUDA `vol` (no counter: the caller counts);
    `name` labels the errors."""
    _check_volume(vol)
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    taps = _taps(kernel, name)
    z, y, x = (int(s) for s in vol.shape)
    out = torch.empty((z, y, x), dtype=torch.float32, device=vol.device)
    cuda.check(
        cuda.library().pnr_conv1d_axis(
            vol.data_ptr(), int(vol.dtype == torch.uint8), out.data_ptr(), z, y, x, axis,
            taps.ctypes.data, int(taps.size), int(bool(grad_border)),
            cuda.raw_stream(vol.device.index),
        ),
        "pnr_conv1d_axis",
    )
    return out


class ConvPlan(NamedTuple):
    """K3's launch: grid and block (x, y, z), dynamic shared bytes, the
    columns a thread of the column kernel owns (4 where the rows allow
    4-wide loads), and whether the grid fits the card's limits."""

    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem: int
    vec: int
    ok: bool


def conv1d_plan(shape: Sequence[int], axis: int, ntaps: int, vec4: bool) -> ConvPlan:
    """K3's launch for a (Z, Y, X) volume (csrc/conv.cu `conv1d_launch`);
    `vec4`: X is a multiple of 4 and the input is aligned to 4 elements."""
    z, y, x = (int(s) for s in shape)
    if axis == 2:
        grid = (-(-x // ROW_SEG), -(-y // ROWS), z)
        block = (32, ROWS, 1)
        smem, vec = ROWS * (ROW_SEG + 4 * -(-ntaps // 4)) * 4, 1
    else:
        n, other = (z, y) if axis == 0 else (y, z)
        vec = 4 if vec4 else 1
        grid = (-(-n // RUN_COLS), -(-x // (COLS_X * vec)), -(-other // COLS_O))
        block = (COLS_X, COLS_O, 1)
        smem = 0
    return ConvPlan(grid, block, smem, vec, y * x < 2**32 and grid[1] <= 65535 and grid[2] <= 65535)


def thread_outputs(plan: ConvPlan, shape: Sequence[int], axis: int, b, t):
    """The (z, y, x) outputs thread t = (tx, ty) of block b = (bx, by, bz)
    forms, as the kernel forms them (none where it lies past the volume)."""
    z, y, x = (int(s) for s in shape)
    (bx, by, bz), (tx, ty) = b, t
    if axis == 2:
        yy = by * ROWS + ty
        if yy >= y:
            return []
        x0 = bx * ROW_SEG + 4 * tx
        return [(bz, yy, xx) for xx in range(x0, min(x0 + 4, x))]
    n, other = (z, y) if axis == 0 else (y, z)
    xx = (by * COLS_X + tx) * plan.vec
    o = bz * COLS_O + ty
    if xx >= x or o >= other:
        return []
    out = []
    for p in range(bx * RUN_COLS, min(bx * RUN_COLS + RUN_COLS, n)):
        for v in range(plan.vec):
            out.append((p, o, xx + v) if axis == 0 else (o, p, xx + v))
    return out


def thread_reads(plan: ConvPlan, length: int, axis: int, ntaps: int, b, t):
    """The positions along `axis` (before clamping to [0, length)) whose
    inputs thread t of block b loads: the column kernel's register window
    or the x kernel's shared segment."""
    half = ntaps // 2
    groups = -(-ntaps // 4)
    if axis == 2:
        lo = b[0] * ROW_SEG - half
        return range(lo, lo + ROW_SEG + 4 * groups)
    lo = b[0] * RUN_COLS - half
    return range(lo, lo + RUN_COLS + 4 * groups)


def conv1d_axis_plain(vol: torch.Tensor, kernel, axis: int, grad_border: bool = False):
    """The plain version of K3 (see the module docstring)."""
    kernel = np.asarray(kernel, np.float32)
    half = kernel.shape[0] // 2
    n = vol.shape[axis]
    idx = torch.arange(-half, n + half, device=vol.device).clamp_(0, n - 1)
    xp = vol.to(torch.float32).index_select(axis, idx)
    out = None
    for j in range(kernel.shape[0]):
        term = float(kernel[j]) * xp.narrow(axis, j, n)
        out = term if out is None else out + term
    if grad_border:
        out.narrow(axis, 0, 1).mul_(2.0)
        if n > 1:
            out.narrow(axis, n - 1, 1).mul_(2.0)
    return out


def conv_yx(vol: torch.Tensor, kernel_y, kernel_x) -> torch.Tensor:
    """The y then the x correlation of a (Z, Y, X) `vol`, edge-replicated;
    float32 out."""
    if vol.device.type == "cpu":
        return conv_yx_plain(vol, kernel_y, kernel_x)
    return _conv_yx_cuda(vol, kernel_y, kernel_x)


def _conv_yx_cuda(vol, kernel_y, kernel_x):
    global CONV_YX_LAUNCHES
    _check_volume(vol)
    ky, kx = _taps(kernel_y, "conv_yx"), _taps(kernel_x, "conv_yx")
    z, y, x = (int(s) for s in vol.shape)
    plan = conv_yx_plan((z, y, x), int(ky.size), int(kx.size), vol.dtype == torch.uint8)
    if not plan.ok:
        raise ValueError(f"conv_yx: a ({z}, {y}, {x}) volume needs a grid of {plan.grid} blocks, "
                         "past the card's 65535 along y and z")
    out = torch.empty((z, y, x), dtype=torch.float32, device=vol.device)
    cuda.check(
        cuda.library().pnr_conv_yx(
            vol.data_ptr(), int(vol.dtype == torch.uint8), out.data_ptr(), z, y, x,
            ky.ctypes.data, int(ky.size), kx.ctypes.data, int(kx.size),
            cuda.raw_stream(vol.device.index),
        ),
        "pnr_conv_yx",
    )
    with cuda.COUNT_LOCK:
        CONV_YX_LAUNCHES += 1
    return out


class YxGeom(NamedTuple):
    """K4's block for tiles of `ty` x YX_TILE_X outputs (csrc/conv.cu
    `yx_geom`): the y pass's columns (`ncols`, the x pass's reach), the
    window's rows (its register window reads up to 4 past the last it
    uses), the ring's slots (the current window and the next tile's new
    rows), a slot's left margin and pitch in bytes, the pitch of the
    y-smoothed rows in floats, and the dynamic shared bytes (the taps
    padded to multiples of 4, row and slot offsets, y-smoothed rows,
    ring)."""

    ty: int
    ncols: int
    rows: int
    nring: int
    margin: int
    pitch: int
    tmpw: int
    smem: int


def _round16(v: int) -> int:
    return (v + 15) & ~15


def yx_geom(nky: int, nkx: int, itemsize: int, ty: int) -> YxGeom:
    ncols = YX_TILE_X + nkx - 1
    rows = ty + 4 * -(-nky // 4)
    nring = 2 * ty + nky - 1
    margin = _round16((nkx // 2) * itemsize)
    pitch = margin + _round16(ncols * itemsize + 15)
    tmpw = YX_TILE_X + 4 * -(-nkx // 4)
    smem = (16 * (-(-nky // 4) + -(-nkx // 4)) + 4 * rows + 16 * -(-nring // 4)
            + 4 * ty * tmpw + nring * pitch)
    return YxGeom(ty, ncols, rows, nring, margin, pitch, tmpw, smem)


class YxPlan(NamedTuple):
    """K4's launch: grid and block (x, y, z), dynamic shared bytes, the
    tile's height and width, the rows a y-pass thread forms, whether the
    grid fits the card's limits, the block's geometry and the y tiles a
    block walks."""

    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem: int
    ty: int
    tx: int
    run: int
    ok: bool
    geom: YxGeom
    tiles: int


@functools.lru_cache(maxsize=256)
def conv_yx_plan(shape: Sequence[int], nky: int, nkx: int, in_is_u8: bool,
                 blocks: int = YX_BLOCKS) -> YxPlan:
    """K4's launch for a (Z, Y, X) volume (csrc/conv.cu `conv_yx_launch`,
    which aims for YX_BLOCKS blocks; the CPU tests ask for fewer, so that
    small volumes take long walks); raises with the shape and taps where
    K4 takes no such taps."""
    z, y, x = (int(s) for s in shape)
    for n in (nky, nkx):
        if n < 1 or n > MAX_TAPS or n % 2 == 0:
            raise ValueError(f"conv_yx of a {(z, y, x)} volume with {nky} y and {nkx} x taps: "
                             f"K4 takes an odd number of taps <= {MAX_TAPS}")
    itemsize = 1 if in_is_u8 else 4
    for ty in YX_TILE_YS:
        geom = yx_geom(nky, nkx, itemsize, ty)
        if geom.smem <= SMEM_LIMIT // 4:
            break
    gx, gy = -(-x // YX_TILE_X), -(-y // geom.ty)
    tiles = min(gy, max(1, gx * gy * z // blocks))
    groups = -(-gy // tiles)
    tiles = -(-gy // groups)
    grid = (gx, groups, z)
    ok = geom.smem <= SMEM_LIMIT and grid[1] <= 65535 and grid[2] <= 65535
    return YxPlan(grid, (32 * YX_WARPS, 1, 1), geom.smem, geom.ty, YX_TILE_X, YX_RUN, ok, geom,
                  tiles)


def yx_walk(plan: YxPlan, shape: Sequence[int], nky: int, nkx: int, itemsize: int, base: int,
            b):
    """K4's block b = (bx, by, bz) walking its y tiles, for a volume whose
    first element is at byte address `base`, step by step as the kernel
    takes them. Returns (nleft, clast, init, first, steps): the columns
    left of window column `nleft` take its value and those right of
    `clast` take clast's; `init` the (slot, offset) pairs set before any
    copy (a walk of one tile: the slots its window leaves empty); `first` the copies of the first window; each step (y0, copies,
    landed, rowslot): the copies in flight into the ring while the step
    works (the next tile's new rows), the slots whose rows landed for it,
    and the slot each of its window rows reads (at the offset last
    recorded for the slot). A copy is (slot, dst, src, nch, offset): nch
    16-byte chunks from the aligned byte address src to ring byte dst,
    and the offset of window column 0 recorded for the slot."""
    _, yy, xx = (int(s) for s in shape)
    g = plan.geom
    ty, hy = g.ty, nky // 2
    bx, by, bz = b
    gy_tiles = -(-yy // ty)
    t0 = by * plan.tiles
    nt = min(plan.tiles, gy_tiles - t0)
    yb, cx = t0 * ty, bx * YX_TILE_X - nkx // 2
    gxa, gxb = max(cx, 0), min(cx + g.ncols - 1, xx - 1)
    nleft, clast = gxa - cx, gxb - cx
    length = (gxb - gxa + 1) * itemsize
    staged = ty + nky - 1

    def stage(j0, j1):
        out = []
        for j in range(j0, j1):
            slot = j % g.nring
            gy = min(max(yb - hy + j, 0), yy - 1)
            src = base + ((bz * yy + gy) * xx + gxa) * itemsize
            lead = src & 15
            dst = slot * g.pitch + g.margin
            out.append((slot, dst, src - lead, (lead + length + 15) >> 4,
                        dst + lead - nleft * itemsize))
        return out

    # a walk of one tile has no copies in flight to record these slots
    init = [(s, s * g.pitch + g.margin) for s in range(staged, g.nring)] if nt == 1 else []
    first = stage(0, staged)
    steps = []
    for k in range(nt):
        j_hi = k * ty + staged
        j_lo = 0 if k == 0 else j_hi - ty
        copies = stage(j_hi, j_hi + ty) if k + 1 < nt else []
        landed = [j % g.nring for j in range(j_lo, j_hi)]
        rowslot = [(k * ty + r) % g.nring for r in range(g.rows)]
        steps.append((yb + k * ty, copies, landed, rowslot))
    return nleft, clast, init, first, steps


def yx_y_items(plan: YxPlan, t: int):
    """The (column, first row) items of the y pass that thread t of a K4
    block forms, stepped as the kernel steps them (no division)."""
    g = plan.geom
    c, run, out = t, 0, []
    while c >= g.ncols:
        c, run = c - g.ncols, run + 1
    while run < g.ty // YX_RUN:
        out.append((c, run * YX_RUN))
        c += plan.block[0]
        while c >= g.ncols:
            c, run = c - g.ncols, run + 1
    return out


def yx_x_outputs(plan: YxPlan, shape: Sequence[int], b, t):
    """The (z, y, x) outputs thread t of K4's block b = (bx, by, bz) forms
    in the x pass of each tile of its walk (warp t // 32 takes rows 2 (t
    // 32) + half, + 16, ..., the half-warp `half` = t % 32 // 16; a lane
    YX_LANE x), with the step and the tile row each comes from."""
    _, yy, xx = (int(s) for s in shape)
    bx, by, bz = b
    warp, lane = divmod(t, 32)
    xo = bx * YX_TILE_X + YX_LANE * (lane % 16)
    out = []
    t0 = by * plan.tiles
    for k in range(min(plan.tiles, -(-yy // plan.ty) - t0)):
        for r in range(2 * warp + lane // 16, plan.ty, 2 * YX_WARPS):
            gy = (t0 + k) * plan.ty + r
            if gy >= yy:
                break
            out += [(bz, gy, x, k, r) for x in range(xo, min(xo + YX_LANE, xx))]
    return out


def conv_yx_plain(vol: torch.Tensor, kernel_y, kernel_x) -> torch.Tensor:
    """The plain version of K4: y first, then x, as the TPU kernel runs."""
    return conv1d_axis_plain(conv1d_axis_plain(vol, kernel_y, 1), kernel_x, 2)
