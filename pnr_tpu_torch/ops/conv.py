"""K3 and K4: the 1-D and fused y-x correlations of the unfused Frangi.

Port of pnr_tpu/ops/pallas_conv.py. `conv1d_axis` replaces
`pallas_conv1d_along_axis` (K3, Pallas `_pallas_conv`) and `conv_yx`
replaces `pallas_conv_yx` (K4, Pallas `_pallas_conv_yx`); the CUDA
kernels are in csrc/conv.cu (`conv1d_axis_kernel`, `conv_yx_kernel`).
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
which outputs a thread forms and which inputs it loads.
"""

from __future__ import annotations

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
    out = torch.empty((z, y, x), dtype=torch.float32, device=vol.device)
    cuda.check(
        cuda.library().pnr_conv_yx(
            vol.data_ptr(), int(vol.dtype == torch.uint8), out.data_ptr(), z, y, x,
            ky.ctypes.data, int(ky.size), kx.ctypes.data, int(kx.size),
            cuda.raw_stream(vol.device.index),
        ),
        "pnr_conv_yx",
    )
    CONV_YX_LAUNCHES += 1
    return out


def conv_yx_plain(vol: torch.Tensor, kernel_y, kernel_x) -> torch.Tensor:
    """The plain version of K4: y first, then x, as the TPU kernel runs."""
    return conv1d_axis_plain(conv1d_axis_plain(vol, kernel_y, 1), kernel_x, 2)
