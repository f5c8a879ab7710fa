"""Tube-approximation ZNCC from precomputed maps (tube mode).

Port of pnr_tpu/ops/zncc_fast.py. The template is a cylinder whose
weights do not depend on the position along its axis, so the three
template sums of the ZNCC become sums along the query direction of three
dense convolution maps per sigma (the module docstring of the JAX package
derives it):

  M1 = I (*) exp(-|r|^2 / 2 s^2),  M2 = I (*) box_{3s},  M3 = I^2 (*) box_{3s}

and corr = (T1 - gbar*T2) / sqrt((T3 - T2^2/N) * corrc), max over the
sigmas, the earliest sigma winning ties. The constants come from the
`TubeZnccModel` (ops/zncc_model.py, a copy of the JAX package's).

* Map builds: `build_tube_maps` (planar (3S, Z, Y, X), for the global
  gather form), `build_tube_maps_packed` ((S, Z, Y, 3X), x-major with the
  three channels interleaved, for the patch engine) and the Z-streamed
  `build_tube_maps_packed_blocked` (float32 or bfloat16 field). Their
  1-D correlations run `conv1d_along_axis` (ops/gaussian.py): the XLA
  shift-and-add on the CPU, `pnr_gauss1d` on a card.
* `make_tube_zncc_fn`: the global gather form, plain torch on
  `ops/interp.trilinear`.
* `TubePatchEngine`: the tracer's per-trace-patch evaluator with the JAX
  engine's window arithmetic; `corr` samples the windows through K5 and
  `eval_fused` (seed scoring) samples the field through K6
  (ops/hat_sample.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops.zncc_model import TubeZnccModel
from pnr_tpu_torch.ops.conv import conv1d_axis_plain
from pnr_tpu_torch.ops.gaussian import conv1d_along_axis
from pnr_tpu_torch.ops.hat_sample import hat_sample_field, hat_sample_patch, slice_windows
from pnr_tpu_torch.ops.interp import trilinear
from pnr_tpu_torch.ops.zncc import _FLT_MIN


class TubeTables(NamedTuple):
    """`TubeZnccModel`'s constants as float32 tensors on one device."""

    alpha1: torch.Tensor  # (S,)
    alpha2: torch.Tensor  # (S,)
    gbar: torch.Tensor  # (S,)
    n: torch.Tensor  # (S,)
    corrc: torch.Tensor  # (S,)
    sigmas: torch.Tensor  # (S,)
    vgrid: torch.Tensor  # (S, NV) offsets along the direction, zero-padded
    vmask: torch.Tensor  # (S, NV) 1 where vgrid is a real sample


def tube_tables(model: TubeZnccModel, device) -> TubeTables:
    s = len(model.sigmas)
    nv = max(len(v) for v in model.v_grids)
    vgrid = np.zeros((s, nv), np.float32)
    vmask = np.zeros((s, nv), np.float32)
    for i, vv in enumerate(model.v_grids):
        vgrid[i, : len(vv)] = vv
        vmask[i, : len(vv)] = 1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return TubeTables(
        alpha1=t(model.alpha1), alpha2=t(model.alpha2), gbar=t(model.gbar), n=t(model.n),
        corrc=t(model.corrc), sigmas=t(np.asarray(model.sigmas)), vgrid=t(vgrid),
        vmask=t(vmask),
    )


def field_from_numpy(maps: np.ndarray, device) -> torch.Tensor:
    """A packed (S, Z, Y, 3X) field built elsewhere (the JAX package's,
    as a numpy array) as a tensor on `device`, in its dtype: float32, or
    bfloat16 (numpy's ml_dtypes bfloat16, converted without rounding)."""
    a = np.asarray(maps)
    if a.dtype.name not in ("float32", "bfloat16"):
        raise TypeError(f"a tube field is float32 or bfloat16, got {a.dtype}")
    t = torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy
    return t.to(device=device, dtype=torch.bfloat16 if a.dtype.name == "bfloat16" else None)


# -- map builds ---------------------------------------------------------


def _separable(vol: torch.Tensor, k, conv) -> torch.Tensor:
    """x, then y, then z correlation with the same 1-D kernel."""
    return conv(conv(conv(vol, k, 2), k, 1), k, 0)


def _tube_map_planes(img: torch.Tensor, model: TubeZnccModel, conv=conv1d_along_axis):
    """Per-sigma (M1, M2, M3) float32 map volumes of a (Z, Y, X) volume."""
    if model.is2d:
        raise NotImplementedError("2-D stacks are not ported yet (ROADMAP.md, port queue: 2-D)")
    f = img.to(torch.float32)
    f2 = f * f
    for i in range(len(model.sigmas)):
        box = np.ones(2 * model.box_half[i] + 1, np.float32)
        yield (
            _separable(f, model.gauss_kernels[i], conv),
            _separable(f, box, conv),
            _separable(f2, box, conv),
        )


def _pack(m1, m2, m3) -> torch.Tensor:
    z, y, x = m1.shape
    return torch.stack([m1, m2, m3], dim=-1).reshape(z, y, 3 * x)


def build_tube_maps(img: torch.Tensor, model: TubeZnccModel) -> torch.Tensor:
    """The planar (3S, Z, Y, X) map stack [M1_0, M2_0, M3_0, M1_1, ...]."""
    return torch.stack([m for planes in _tube_map_planes(img, model) for m in planes])


def _packed(img: torch.Tensor, model: TubeZnccModel, conv) -> torch.Tensor:
    z, y, x = (int(d) for d in img.shape)
    out = torch.empty((len(model.sigmas), z, y, 3 * x), dtype=torch.float32, device=img.device)
    for si, planes in enumerate(_tube_map_planes(img, model, conv)):
        out[si] = _pack(*planes)
    return out


def build_tube_maps_packed(img: torch.Tensor, model: TubeZnccModel) -> torch.Tensor:
    """The (S, Z, Y, 3X) float32 field: element (s, z, y, 3x + c) holds
    channel c of sigma s at column x."""
    return _packed(img, model, conv1d_along_axis)


def build_tube_maps_packed_plain(img: torch.Tensor, model: TubeZnccModel) -> torch.Tensor:
    """The packed build through the plain shift-and-add on any device:
    what `build_tube_maps_packed` is held to on a card."""
    return _packed(img, model, conv1d_axis_plain)


def build_tube_maps_packed_blocked(
    img: torch.Tensor, model: TubeZnccModel, dtype=torch.float32, block_z: int = 64
) -> torch.Tensor:
    """The packed field built in Z blocks of `block_z` planes, stored in
    `dtype` (float32 or bfloat16, rounded to nearest even).

    Each block reads a slab with a replicated z halo of ceil(3*sigma_max)
    planes, so its planes see the same inputs as the monolithic build; a
    tail block is clamped to end at the last plane and recomputes the
    overlap. Without a second block (or when Z <= 2*halo) this is the
    monolithic build cast to `dtype`."""
    s = len(model.sigmas)
    z, y, x = (int(d) for d in img.shape)
    halo = max(int(math.ceil(3.0 * sig)) for sig in model.sigmas)
    bz = min(block_z, z)
    nblk = -(-z // bz)
    if nblk == 1 or z <= 2 * halo:
        return build_tube_maps_packed(img, model).to(dtype)
    zi = torch.arange(-halo, z + halo, device=img.device).clamp_(0, z - 1)
    vp = img.index_select(0, zi)
    out = torch.empty((s, z, y, 3 * x), dtype=dtype, device=img.device)
    for i in range(nblk):
        z0 = min(i * bz, z - bz)
        slab = vp[z0 : z0 + bz + 2 * halo]
        for si, (m1, m2, m3) in enumerate(_tube_map_planes(slab, model)):
            sl = slice(halo, halo + bz)
            out[si, z0 : z0 + bz] = _pack(m1[sl], m2[sl], m3[sl]).to(dtype)
    return out


# -- correlation ----------------------------------------------------------


def corr_from_sums(tables: TubeTables, s1, s2, s3):
    """ZNCC from the three tube sums (..., S), max over the sigmas; the
    earliest sigma wins a tie (torch.argmax returns the first maximum)."""
    s1 = s1 * tables.alpha1
    s2 = s2 * tables.alpha2
    s3 = s3 * tables.alpha2
    corra = s1 - tables.gbar * s2
    corrb = torch.clamp(s3 - (s2 * s2) / tables.n, min=0.0)
    denom = corrb * tables.corrc
    corrs = torch.where(
        denom > _FLT_MIN,
        corra / torch.sqrt(torch.clamp(denom, min=_FLT_MIN)),
        torch.zeros_like(denom),
    )
    best = torch.argmax(corrs, dim=-1)
    return torch.amax(corrs, dim=-1), tables.sigmas[best]


def make_tube_zncc_fn(model: TubeZnccModel):
    """(planar maps (3S, Z, Y, X), pos (N, 3), dirs (N, 3)) -> (corr, sig),
    sampling the maps with `trilinear` at p + v*dir."""

    def fn(maps, pos, dirs):
        sums = []  # sums[c][si]: (N,) tube sum of channel c at sigma si
        for si, vg in enumerate(model.v_grids):
            vv = torch.from_numpy(vg).to(maps.device)
            pts = pos[:, None, :] + vv[None, :, None] * dirs[:, None, :]
            x, y, z = pts[None, ..., 0], pts[None, ..., 1], pts[None, ..., 2]
            sums.append([trilinear(maps[3 * si + c][None], x, y, z)[0].sum(dim=1) for c in range(3)])
        s1, s2, s3 = (torch.stack([s[c] for s in sums], dim=-1) for c in range(3))
        return corr_from_sums(tube_tables(model, maps.device), s1, s2, s3)

    return fn


def _ext(h: int) -> int:
    """Window extent for half-width h, rounded up to a multiple of 8 (the
    JAX engine's rounding: it decides where stray samples clamp)."""
    return -(-(2 * h + 2) // 8) * 8


class TubePatchEngine:
    """Per-trace-patch tube ZNCC on the packed field (S, Z, Y, 3X).

    Port of `make_tube_patch_engine` (pnr_tpu/ops/zncc_fast.py), with its
    window arithmetic kept exactly: windows per contiguous run of sigmas
    sharing (pz, py, px) (`groups`), sized for a cloud allowance of
    (2 + reuse) * step around the extraction-time centre plus each sigma's
    line extent, rounded up to a multiple of 8 and clipped to the volume.
    A sample outside its window clamps to the window's edge.

    extract(maps, center (T, 3) xyz) -> (patches, corners), one float32
        (T, gs, pz, py, 3px) patch tensor and one (T, 3) zyx corner per
        sigma group
    corr(vol_dims, patches, corners, pos (T, N, 3), dirs) -> (corr, sig),
        both (T, N), through K5
    eval_fused(maps, pos, dirs): the same with one (sigma_max) window per
        trace centred on the mean of its queries, sampled from the field
        through K6 (a bfloat16 field goes through extract + corr, which
        widen the patches to float32)

    The tables live on `device` (the card by default); given `tables`, the
    engine takes them, and their device, as they are.
    """

    def __init__(
        self, model: TubeZnccModel, step: float, zdist: float = 1.0, reuse: int = 1,
        device="cuda", tables: TubeTables = None,
    ):
        if model.is2d:
            raise NotImplementedError("2-D stacks are not ported yet (ROADMAP.md, port queue: 2-D)")
        self.tables = tables if tables is not None else tube_tables(model, device)
        self.s_count = len(model.sigmas)
        self.nv = max(len(v) for v in model.v_grids)
        self.v2_per_sigma = [int(math.ceil(float(v.max()))) for v in model.v_grids]
        allowance = (2.0 + max(1, int(reuse))) * float(step)
        self.half = int(math.ceil(allowance)) + max(self.v2_per_sigma) + 1
        self.cloud_xy = int(math.ceil(allowance))
        self.cloud_z = int(math.ceil(allowance / float(zdist)))

    @staticmethod
    def vol_dims(maps_shape) -> Tuple[int, int, int]:
        """True (Z, Y, X) volume dims of the packed (S, Z, Y, 3X) field."""
        _, l, h, w3 = (int(d) for d in maps_shape)
        return l, h, w3 // 3

    def dims(self, vol_dims) -> Tuple[int, int, int]:
        """The sigma_max window in every axis (eval_fused's)."""
        ext = _ext(self.half)
        return tuple(int(min(ext, d)) for d in vol_dims)

    def groups(self, vol_dims):
        """[(g0, g1, (pz, py, px))]: contiguous sigma runs sharing window dims."""
        l, h, w = vol_dims
        dims = []
        for v2 in self.v2_per_sigma:
            ez = _ext(self.cloud_z + v2 + 1)
            exy = _ext(self.cloud_xy + v2 + 1)
            dims.append((int(min(ez, l)), int(min(exy, h)), int(min(exy, w))))
        out, g0 = [], 0
        for i in range(1, self.s_count + 1):
            if i == self.s_count or dims[i] != dims[g0]:
                out.append((g0, i, dims[g0]))
                g0 = i
        return out

    @staticmethod
    def corners(vol_dims, center: torch.Tensor, pdims) -> torch.Tensor:
        """(T, 3) int32 zyx window origins around `center` (T, 3) xyz."""
        l, h, w = vol_dims
        pz, py, px = pdims
        c = torch.round(center).to(torch.int32)
        cx = torch.clamp(c[:, 0] - px // 2, 0, w - px)
        cy = torch.clamp(c[:, 1] - py // 2, 0, h - py)
        cz = torch.clamp(c[:, 2] - pz // 2, 0, l - pz)
        return torch.stack([cz, cy, cx], dim=-1).contiguous()

    def extract(self, maps: torch.Tensor, center: torch.Tensor):
        vdims = self.vol_dims(maps.shape)
        patches, corners = [], []
        for g0, g1, pdims in self.groups(vdims):
            corner = self.corners(vdims, center, pdims)
            pat = slice_windows(maps, corner, pdims, g0, g1 - g0)
            patches.append(pat.to(torch.float32))
            corners.append(corner)
        return tuple(patches), tuple(corners)

    def rel_coords(self, vol_dims, pdims, corner, pos, dirs, g0=0, g1=None) -> torch.Tensor:
        """(T, g1-g0, N*NV, 4) rows (rz, ry, rx, 0): the samples p + v*dir
        of sigmas [g0, g1), clamped to the volume, then into the window."""
        g1 = self.s_count if g1 is None else g1
        l, h, w = vol_dims
        pz, py, px = pdims
        t, n = pos.shape[:2]
        vg = self.tables.vgrid[g0:g1]
        pts = pos[:, :, None, None, :] + vg[None, None, :, :, None] * dirs[:, :, None, None, :]
        pts = pts.permute(0, 2, 1, 3, 4).reshape(t, g1 - g0, n * self.nv, 3)
        cf = corner.to(torch.float32)[:, None, None, :]
        rx = torch.clamp(torch.clamp(pts[..., 0], 0.0, w - 1.001) - cf[..., 2], 0.0, px - 1.001)
        ry = torch.clamp(torch.clamp(pts[..., 1], 0.0, h - 1.001) - cf[..., 1], 0.0, py - 1.001)
        rz = torch.clamp(torch.clamp(pts[..., 2], 0.0, l - 1.001) - cf[..., 0], 0.0, pz - 1.001)
        return torch.stack([rz, ry, rx, torch.zeros_like(rx)], dim=-1)

    def finish(self, v: torch.Tensor, t: int, n: int):
        """(T, S, N*NV, 3) sample values -> (corr, sig), both (T, N)."""
        v = v.reshape(t, self.s_count, n, self.nv, 3)
        sums = (v * self.tables.vmask[None, :, None, :, None]).sum(dim=3)  # (T, S, N, 3)
        s1, s2, s3 = (sums[..., c].permute(0, 2, 1) for c in range(3))
        return corr_from_sums(self.tables, s1, s2, s3)

    def corr(self, vol_dims, patches, corners, pos, dirs):
        t, n = pos.shape[:2]
        vs, g0 = [], 0
        for pat, corner in zip(patches, corners):
            _, gs, pz, py, px3 = pat.shape
            rel = self.rel_coords(vol_dims, (pz, py, px3 // 3), corner, pos, dirs, g0, g0 + gs)
            vs.append(hat_sample_patch(pat, rel)[..., :3])
            g0 += gs
        v = vs[0] if len(vs) == 1 else torch.cat(vs, dim=1)
        return self.finish(v, t, n)

    def eval_fused(self, maps: torch.Tensor, pos: torch.Tensor, dirs: torch.Tensor):
        t, n = pos.shape[:2]
        center = pos.mean(dim=1)
        vdims = self.vol_dims(maps.shape)
        if maps.dtype != torch.float32:
            patches, corners = self.extract(maps, center)
            return self.corr(vdims, patches, corners, pos, dirs)
        pdims = self.dims(vdims)
        corner = self.corners(vdims, center, pdims)
        rel = self.rel_coords(vdims, pdims, corner, pos, dirs)
        m = n * self.nv
        out = hat_sample_field(maps, corner, rel.reshape(t, self.s_count * m, 4), pdims)
        return self.finish(out.reshape(t, self.s_count, m, 4)[..., :3], t, n)
