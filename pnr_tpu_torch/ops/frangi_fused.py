"""K1: multi-scale Frangi as a hand-written CUDA kernel (csrc/frangi_fused.cu).

Port of pnr_tpu/ops/frangi_fused.py (`frangi3d_fused`, whose Pallas
`_kernel` is the TPU kernel replaced). Same contract as `frangi3d`:
(J, Jmin, Jmax, Vx, Vy, Vz). A CPU tensor runs the plain PyTorch chain
(`frangi3d_plain`, ops/frangi.py); a CUDA tensor runs the kernels or raises.

Per sigma the CUDA route makes three launches of an edge-replicated 1-D
Gaussian pass (x, y, z) into f32 scratch and one per-voxel launch that
forms the Hessian, solves the eigenproblem, gates the vesselness and
merges it into J and the three uint8 direction volumes; Jmin/Jmax come
from block reductions and ordered-int atomics inside the same launches.
The scratch is two f32 volumes (~420 MB at 52.4 Mvox).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from pnr_tpu_torch.ops import cuda
from pnr_tpu_torch.ops.frangi import frangi3d_plain
from pnr_tpu_torch.ops.gaussian import gaussian_kernel

#: CUDA kernel launches through the CUDA route (per sigma three Gaussian
#: passes and one scale pass, plus the Jmin/Jmax decode after the last
#: scale), so a run can show that the main path went through the kernels
LAUNCHES = 0


def fused_frangi_enabled() -> bool:
    """The PNR_TPU_FUSED_FRANGI switch (any value but "0", "" or "false"
    forces K1 on), read as pnr_tpu's `fused_frangi_enabled` reads it."""
    return os.environ.get("PNR_TPU_FUSED_FRANGI", "0") not in ("0", "", "false")


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
    lib = cuda.library()
    dev = vol.device
    stream = cuda.raw_stream(vol.device.index)
    j = torch.empty((z, y, x), dtype=torch.float32, device=dev)
    qx = torch.empty((z, y, x), dtype=torch.uint8, device=dev)
    qy = torch.empty_like(qx)
    qz = torch.empty_like(qx)
    tmp_a = torch.empty_like(j)
    tmp_b = torch.empty_like(j)
    # ordered-int (min, max) accumulators: 0xffffffff, 0
    stats = torch.tensor([-1, 0], dtype=torch.int32, device=dev)
    minmax = torch.empty(2, dtype=torch.float32, device=dev)
    a2 = 2.0 * float(alpha) * float(alpha)
    b2 = 2.0 * float(beta) * float(beta)
    c2 = 2.0 * float(c) * float(c)
    ns = len(sigmas)
    for si, sig in enumerate(sigmas):
        sig = float(sig)
        kxy = torch.from_numpy(gaussian_kernel(sig)).to(dev)
        kz = torch.from_numpy(gaussian_kernel(sig / float(zdist))).to(dev)
        for src, is_u8, dst, axis, taps in (
            (vol, 1, tmp_a, 2, kxy),
            (tmp_a, 0, tmp_b, 1, kxy),
            (tmp_b, 0, tmp_a, 0, kz),
        ):
            cuda.check(
                lib.pnr_gauss1d(
                    src.data_ptr(), is_u8, dst.data_ptr(), z, y, x, axis,
                    taps.data_ptr(), int(taps.numel()), stream,
                ),
                "pnr_gauss1d",
            )
            LAUNCHES += 1
        cuda.check(
            lib.pnr_frangi_scale(
                tmp_a.data_ptr(), z, y, x, float(np.float32(sig * sig)), a2, b2, c2,
                int(bool(blackwhite)), int(si == 0), int(si == ns - 1),
                j.data_ptr(), qx.data_ptr(), qy.data_ptr(), qz.data_ptr(),
                stats.data_ptr(), minmax.data_ptr(), stream,
            ),
            "pnr_frangi_scale",
        )
        LAUNCHES += 2 if si == ns - 1 else 1
    return j, minmax[0], minmax[1], qx, qy, qz
