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
"""

from __future__ import annotations

import numpy as np
import torch

from pnr_tpu_torch.ops import cuda

#: CUDA launches of K3 (`conv1d_axis`), one per call
CONV1D_LAUNCHES = 0
#: CUDA launches of K4 (`conv_yx`), one per call
CONV_YX_LAUNCHES = 0
#: the most taps a kernel takes (csrc/conv.cu kMaxTaps): sigma <= 21
MAX_TAPS = 127


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
    _check_volume(vol)
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    taps = _taps(kernel, "conv1d_axis")
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
    CONV1D_LAUNCHES += 1
    return out


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
