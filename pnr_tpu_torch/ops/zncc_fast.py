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
  shift-and-add on the CPU, K3 (`conv.launch_conv1d`) on a card.
* `make_tube_zncc_fn`: the global gather form, plain torch on
  `ops/interp.trilinear`.
* `TubePatchEngine`: the tracer's per-trace-window evaluator with the JAX
  engine's window arithmetic; the tracer (`window` + `likelihood`) and
  seed scoring (`eval_fused`) evaluate through `tube_corr`
  (ops/tube_corr.py), one launch per evaluation on a card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops.zncc_model import TubeZnccModel
from pnr_tpu_torch.ops.conv import conv1d_axis_plain
from pnr_tpu_torch.ops.gaussian import conv1d_along_axis
from pnr_tpu_torch.ops.interp import trilinear
from pnr_tpu_torch.ops.tube_corr import (
    KernelParams,
    TubeTables,
    check_struct,
    corr_from_sums,
    finish,
    hat_sample_patch_plain,
    rel_coords,
    slice_windows,
    tube_corr,
    tube_tables,
    vol_dims,
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


def _separable(vol: torch.Tensor, k, conv, is2d: bool) -> torch.Tensor:
    """x, then y, then (but for a 2-D model) z correlation with the same
    1-D kernel."""
    v = conv(conv(vol, k, 2), k, 1)
    return v if is2d else conv(v, k, 0)


def _tube_map_planes(img: torch.Tensor, model: TubeZnccModel, conv=conv1d_along_axis):
    """Per-sigma (M1, M2, M3) float32 map volumes of a (Z, Y, X) volume;
    a 2-D model (a one-plane volume) correlates along y and x only."""
    f = img.to(torch.float32)
    f2 = f * f
    for i in range(len(model.sigmas)):
        box = np.ones(2 * model.box_half[i] + 1, np.float32)
        yield (
            _separable(f, model.gauss_kernels[i], conv, model.is2d),
            _separable(f, box, conv, model.is2d),
            _separable(f2, box, conv, model.is2d),
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


class _Layout(NamedTuple):
    """One window table on one device: the groups, each group's corner
    offsets and bounds as (G, 3) int32 zyx tensors, and the kernel's
    constants (None on the CPU)."""

    groups: list  # [(g0, g1, (pz, py, px))]
    half: torch.Tensor  # p // 2
    hi: torch.Tensor  # dim - p
    params: KernelParams
    pdims: torch.Tensor = None  # p, under a slab frame


class TubePatchEngine:
    """Per-trace-window tube ZNCC on the packed field (S, Z, Y, 3X).

    Port of `make_tube_patch_engine` (pnr_tpu/ops/zncc_fast.py), with its
    window arithmetic kept exactly: windows per contiguous run of sigmas
    sharing (pz, py, px) (`groups`), sized for a cloud allowance of
    (2 + reuse) * step around the extraction-time centre plus each sigma's
    line extent, rounded up to a multiple of 8 and clipped to the volume.
    A sample outside its window clamps to the window's edge.

    window(maps, center (T, 3) xyz, single=False) -> (T, G, 3) int32 zyx
        window origins, one per sigma group (`single`: one sigma_max window)
    likelihood(maps, corners, pos (T, N, 3), dirs, single=False) ->
        (corr, sig), both (T, N): the tracer's evaluation, through
        `tube_corr` (TRACE_LAUNCHES)
    eval_fused(maps, pos, dirs): seed scoring, one window per trace
        centred on the mean of its queries, through `tube_corr`
        (SCORE_LAUNCHES): one sigma_max window on a float32 field, the
        group windows on a bfloat16 one (as the JAX engine routes them)
    extract(maps, center) -> (patches, corners) and corr(vol_dims,
        patches, corners, pos, dirs) -> (corr, sig): the JAX engine's
        extract + corr chain on float32 patches, in plain torch on any
        device; `tube_corr_plain` computes it without keeping the patches

    The tables live on `device` (the card by default); given `tables`, the
    engine takes them, and their device, as they are. `window`,
    `likelihood` and `eval_fused` take an optional `frame`
    (ops/slab.SlabFrame): the field is then a slab of a larger volume, in
    whose coordinates positions and windows are (a window that would leave
    the slab is shifted into it).
    """

    def __init__(
        self, model: TubeZnccModel, step: float, zdist: float = 1.0, reuse: int = 1,
        device="cuda", tables: TubeTables = None,
    ):
        self.tables = tables if tables is not None else tube_tables(model, device)
        self.s_count = len(model.sigmas)
        self.nv = max(len(v) for v in model.v_grids)
        self.v2_per_sigma = [int(math.ceil(float(v.max()))) for v in model.v_grids]
        allowance = (2.0 + max(1, int(reuse))) * float(step)
        self.half = int(math.ceil(allowance)) + max(self.v2_per_sigma) + 1
        self.cloud_xy = int(math.ceil(allowance))
        self.cloud_z = int(math.ceil(allowance / float(zdist)))
        self._layouts = {}

    vol_dims = staticmethod(vol_dims)

    def dims(self, vol_dims) -> Tuple[int, int, int]:
        """The sigma_max window in every axis (eval_fused's); one plane on
        a one-plane volume."""
        l, h, w = vol_dims
        ext = _ext(self.half)
        return 1 if l == 1 else int(min(ext, l)), int(min(ext, h)), int(min(ext, w))

    def groups(self, vol_dims):
        """[(g0, g1, (pz, py, px))]: contiguous sigma runs sharing window dims."""
        l, h, w = vol_dims
        dims = []
        for v2 in self.v2_per_sigma:
            ez = _ext(self.cloud_z + v2 + 1)
            exy = _ext(self.cloud_xy + v2 + 1)
            dims.append((1 if l == 1 else int(min(ez, l)), int(min(exy, h)), int(min(exy, w))))
        out, g0 = [], 0
        for i in range(1, self.s_count + 1):
            if i == self.s_count or dims[i] != dims[g0]:
                out.append((g0, i, dims[g0]))
                g0 = i
        return out

    def layout(self, maps: torch.Tensor, single: bool = False, frame=None) -> _Layout:
        """The window table of a field (`single`: one sigma_max window for
        all sigmas), built once per field shape, device and frame."""
        key = (maps.shape, single, maps.device, frame)
        lay = self._layouts.get(key)
        if lay is None:
            fdims = self.vol_dims(maps.shape)
            vdims = fdims if frame is None else tuple(frame.dims)
            groups = [(0, self.s_count, self.dims(vdims))] if single else self.groups(vdims)

            def zyx(f):
                return torch.tensor([[f(d, p) for d, p in zip(vdims, pd)] for *_, pd in groups],
                                    dtype=torch.int32, device=maps.device)

            if not maps.is_cuda:
                params = None
            elif frame is None:
                params = KernelParams(self.tables, groups, vdims, maps.device)
            else:
                params = KernelParams(self.tables, groups, vdims, maps.device, frame.origin, fdims)
            lay = _Layout(groups, zyx(lambda d, p: p // 2), zyx(lambda d, p: d - p), params,
                          None if frame is None else zyx(lambda d, p: p))
            self._layouts[key] = lay
        return lay

    @staticmethod
    def corners(vol_dims, center: torch.Tensor, pdims) -> torch.Tensor:
        """(T, 3) int32 zyx origins of (pz, py, px) windows around `center`
        (T, 3) xyz (torch.round is half-to-even, as jnp.round)."""
        l, h, w = vol_dims
        pz, py, px = pdims
        c = torch.round(center).to(torch.int32)
        cx = torch.clamp(c[:, 0] - px // 2, 0, w - px)
        cy = torch.clamp(c[:, 1] - py // 2, 0, h - py)
        cz = torch.clamp(c[:, 2] - pz // 2, 0, l - pz)
        return torch.stack([cz, cy, cx], dim=-1).contiguous()

    def window(self, maps: torch.Tensor, center: torch.Tensor, single: bool = False, frame=None):
        """`corners` for every group at once: (T, G, 3) int32 zyx."""
        lay = self.layout(maps, single, frame)
        c = torch.round(center).to(torch.int32).flip(-1)
        corners = torch.minimum(torch.clamp(c[:, None, :] - lay.half, min=0), lay.hi)
        if frame is None:
            return corners
        return frame.into(corners, lay.pdims, self.vol_dims(maps.shape))

    def likelihood(self, maps, corners, pos, dirs, single: bool = False, scoring: bool = False,
                   frame=None):
        lay = self.layout(maps, single, frame)
        out, _ = tube_corr(maps, lay.groups, corners, pos, dirs, self.tables, lay.params,
                           scoring=scoring, frame=frame)
        return out[0], out[1]

    def prepare(self, maps: torch.Tensor, b: int, frame=None) -> None:
        """The tracer's window table and `tube_corr`'s constants for this
        field (read through `frame`), made ahead of a CUDA graph capture
        (their copies to the card cannot be captured); `b` is unused: the
        kernel's launch does not depend on it."""
        self.layout(maps, frame=frame)
        if maps.is_cuda:
            check_struct()

    def eval_fused(self, maps: torch.Tensor, pos: torch.Tensor, dirs: torch.Tensor, frame=None):
        single = maps.dtype == torch.float32
        corners = self.window(maps, pos.mean(dim=1), single, frame)
        return self.likelihood(maps, corners, pos, dirs, single, scoring=True, frame=frame)

    def extract(self, maps: torch.Tensor, center: torch.Tensor):
        vdims = self.vol_dims(maps.shape)
        patches, corners = [], []
        for g0, g1, pdims in self.groups(vdims):
            corner = self.corners(vdims, center, pdims)
            pat = slice_windows(maps, corner, pdims, g0, g1 - g0)
            patches.append(pat.to(torch.float32))
            corners.append(corner)
        return tuple(patches), tuple(corners)

    def corr(self, vol_dims, patches, corners, pos, dirs):
        t, n = pos.shape[:2]
        vs, g0 = [], 0
        for pat, corner in zip(patches, corners):
            _, gs, pz, py, px3 = pat.shape
            rel = rel_coords(self.tables, vol_dims, (pz, py, px3 // 3), corner, pos, dirs, g0,
                             g0 + gs)
            vs.append(hat_sample_patch_plain(pat, rel)[..., :3])
            g0 += gs
        v = vs[0] if len(vs) == 1 else torch.cat(vs, dim=1)
        return finish(self.tables, v, t, n)[:2]
