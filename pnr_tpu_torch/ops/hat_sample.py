"""K5 and K6: tube-map hat sampling as hand-written CUDA kernels (csrc/hat_sample.cu).

Port of pnr_tpu/ops/pallas_sample.py: `hat_sample_patch` replaces
`hat_sample_pallas` (K5, Pallas `_kernel`) and `hat_sample_field`
replaces `hat_sample_fused` (K6, Pallas `_fused_kernel`, disabled on the
TPU). Both take x-major channel-packed windows (element (z, y, 3*x + c)
holds map channel c at column x, the layout of
`build_tube_maps_packed`) and rows of patch-relative coordinates
(rz, ry, rx, _), already clamped into [0, p - 1.001] by the caller, and
return (v_m1, v_m2, v_m3, 0) per row: the trilinear sample of each
channel, written as the separable two-tap hat contraction.

Beside each kernel is its plain PyTorch version: for K5 the float32
hat-einsum of the JAX XLA path (`make_tube_patch_engine.corr`,
pnr_tpu/ops/zncc_fast.py), for K6 the windows sliced out of the field
followed by K5's plain version. A CPU tensor runs the plain version; a
CUDA tensor runs the kernel or raises. The TPU's padding of the rows to
a multiple of 8 is Mosaic's and is not kept: the kernels take any row
count.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pnr_tpu_torch.ops import cuda

#: CUDA launches of K5 (`hat_sample_patch`), one per call
PATCH_LAUNCHES = 0
#: CUDA launches of K6 (`hat_sample_field`), one per call
FIELD_LAUNCHES = 0


def _check_window(pdims) -> None:
    if min(pdims) < 2:
        raise ValueError(f"hat sampling needs every window dimension >= 2, got {tuple(pdims)}")


def hat_sample_patch(patches: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """patches (T, Sg, pz, py, 3*px) f32, rel (T, Sg, R, 4) f32 -> (T, Sg, R, 4) f32."""
    if patches.device.type == "cpu":
        return hat_sample_patch_plain(patches, rel)
    return _hat_sample_patch_cuda(patches, rel)


def _hat_sample_patch_cuda(patches, rel):
    global PATCH_LAUNCHES
    cuda.require_cuda_tensor(patches, "patches", torch.float32, 5)
    cuda.require_cuda_tensor(rel, "rel", torch.float32, 4)
    t, sg, pz, py, px3 = (int(s) for s in patches.shape)
    r = int(rel.shape[2])
    if px3 % 3 or tuple(rel.shape) != (t, sg, r, 4):
        raise ValueError(f"bad shapes: patches {tuple(patches.shape)}, rel {tuple(rel.shape)}")
    if rel.device != patches.device:
        raise ValueError(f"rel is on {rel.device}, patches on {patches.device}")
    _check_window((pz, py, px3 // 3))
    out = torch.empty_like(rel)
    cuda.check(
        cuda.library().pnr_hat_sample_patch(
            patches.data_ptr(), t, sg, pz, py, px3 // 3, rel.data_ptr(), r, out.data_ptr(),
            cuda.stream_of(patches),
        ),
        "pnr_hat_sample_patch",
    )
    PATCH_LAUNCHES += 1
    return out


def _hat(q: torch.Tensor, p: int) -> torch.Tensor:
    """(..., R) coordinates -> (..., R, p) weights max(0, 1 - |q - k|)."""
    k = torch.arange(p, dtype=torch.float32, device=q.device)
    return torch.clamp(1.0 - torch.abs(q[..., None] - k), min=0.0)


def hat_sample_patch_plain(patches: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: one (R, pz*py) @ (pz*py, 3*px) product per
    (trace, sigma) with the combined z/y hat weights, then the x hats."""
    t, sg, pz, py, px3 = patches.shape
    px = px3 // 3
    r = rel.shape[2]
    wz = _hat(rel[..., 0], pz)
    wy = _hat(rel[..., 1], py)
    wx = _hat(rel[..., 2], px)
    wzy = (wz[..., :, None] * wy[..., None, :]).reshape(t, sg, r, pz * py)
    a = torch.einsum("tsmq,tsqxc->tsmxc", wzy, patches.reshape(t, sg, pz * py, px, 3))
    v = torch.einsum("tsmx,tsmxc->tsmc", wx, a)
    return torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)


def slice_windows(
    maps: torch.Tensor, corners: torch.Tensor, pdims: Tuple[int, int, int], g0: int = 0,
    gs: int = None,
) -> torch.Tensor:
    """(T, gs, pz, py, 3*px) windows of the packed field `maps`
    (S, Z, Y, 3X) at `corners` (T, 3) zyx, sigmas [g0, g0 + gs), in the
    field's dtype. Corners must lie in [0, dim - p]."""
    s, z, y, x3 = (int(d) for d in maps.shape)
    gs = s - g0 if gs is None else gs
    pz, py, px = pdims

    def ar(n):
        return torch.arange(n, device=maps.device)

    # element offsets of the window from its first element
    off = (((ar(gs) * z)[:, None, None, None] + ar(pz)[:, None, None]) * y
           + ar(py)[:, None]) * x3 + ar(3 * px)
    c = corners.long()
    base = ((g0 * z + c[:, 0]) * y + c[:, 1]) * x3 + 3 * c[:, 2]
    idx = base[:, None] + off.reshape(1, -1)
    return maps.reshape(-1)[idx].reshape(corners.shape[0], gs, pz, py, 3 * px)


def hat_sample_field(
    maps: torch.Tensor, corners: torch.Tensor, rel: torch.Tensor, pdims: Tuple[int, int, int]
) -> torch.Tensor:
    """maps (S, Z, Y, 3*X) f32, corners (T, 3) int32 zyx window origins in
    [0, dim - p], rel (T, S*Mr, 4) f32 (row block s samples sigma s in the
    (pz, py, px) window) -> (T, S*Mr, 4) f32."""
    if maps.device.type == "cpu":
        return hat_sample_field_plain(maps, corners, rel, pdims)
    return _hat_sample_field_cuda(maps, corners, rel, pdims)


def _hat_sample_field_cuda(maps, corners, rel, pdims):
    global FIELD_LAUNCHES
    cuda.require_cuda_tensor(maps, "maps", torch.float32, 4)
    cuda.require_cuda_tensor(corners, "corners", torch.int32, 2)
    cuda.require_cuda_tensor(rel, "rel", torch.float32, 3)
    s, z, y, x3 = (int(d) for d in maps.shape)
    t, rows = int(rel.shape[0]), int(rel.shape[1])
    pz, py, px = (int(p) for p in pdims)
    if x3 % 3 or rows % s or tuple(corners.shape) != (t, 3) or rel.shape[2] != 4:
        raise ValueError(
            f"bad shapes: maps {tuple(maps.shape)}, corners {tuple(corners.shape)}, "
            f"rel {tuple(rel.shape)}"
        )
    for name, v in (("corners", corners), ("rel", rel)):
        if v.device != maps.device:
            raise ValueError(f"{name} is on {v.device}, maps on {maps.device}")
    _check_window((pz, py, px))
    if pz > z or py > y or px > x3 // 3:
        raise ValueError(f"window {(pz, py, px)} exceeds the field {(z, y, x3 // 3)}")
    out = torch.empty_like(rel)
    cuda.check(
        cuda.library().pnr_hat_sample_field(
            maps.data_ptr(), s, z, y, x3 // 3, corners.data_ptr(), t, rel.data_ptr(), rows // s,
            pz, py, px, out.data_ptr(), cuda.stream_of(maps),
        ),
        "pnr_hat_sample_field",
    )
    FIELD_LAUNCHES += 1
    return out


def hat_sample_field_plain(maps, corners, rel, pdims) -> torch.Tensor:
    """Plain version of K6: slice each trace's windows, then K5's plain version."""
    s = int(maps.shape[0])
    t, rows = int(rel.shape[0]), int(rel.shape[1])
    patches = slice_windows(maps, corners, pdims).to(torch.float32)
    out = hat_sample_patch_plain(patches, rel.reshape(t, s, rows // s, 4))
    return out.reshape(t, rows, 4)
