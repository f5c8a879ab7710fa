"""The tube likelihood: `tube_corr`, a hand-written CUDA kernel
(csrc/tube_corr.cu), and its plain PyTorch version.

Port of the tube engine's likelihood in pnr_tpu: the Pallas kernels of
pnr_tpu/ops/pallas_sample.py (`hat_sample_pallas`, the tracer's window
sampling, and `hat_sample_fused`, sampling straight from the field) and
the XLA glue of pnr_tpu/ops/zncc_fast.py around them (`_rel_coords`,
`_finish`, `_corr_from_sums`). One call evaluates the tube ZNCC of every
query (t, n) over its trace's windows in the packed field (S, Z, Y, 3X):
element (s, z, y, 3x + c) holds channel c (M1, M2, M3) of sigma s at
column x, in float32 or bfloat16.

The windows: `groups` is a list [(g0, g1, (pz, py, px))] of contiguous
sigma runs sharing one window shape, and `corners` (T, G, 3) int32 holds
each trace's zyx window origin per group (`TubePatchEngine.window`). The
tracer uses the per-group windows; seed scoring on a float32 field uses
one sigma_max window, a single group (0, S, dims).

* `tube_corr_plain` is the plain chain, the JAX engine's XLA path
  operation for operation: `rel_coords` (the samples p + v*dir clamped to
  the volume, then into the window), `slice_windows` + the hat-einsum
  (`hat_sample_field_plain`, `hat_sample_patch_plain`), `finish` (the
  masked sums over the line and `corr_from_sums`).
* `tube_corr` sends a CPU field to the plain chain and a CUDA field to
  the kernel, or raises: one launch, no patch, no intermediate in device
  memory. The kernel's constants (`KernelParams`, the model tables and the
  window table) are built once per engine and volume shape.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops import cuda
from pnr_tpu_torch.ops.zncc import _FLT_MIN
from pnr_tpu_torch.ops.zncc_model import TubeZnccModel

#: `tube_corr` kernel launches for the tracer's likelihood (K5's row)
TRACE_LAUNCHES = 0
#: `tube_corr` kernel launches for seed scoring (K6's row)
SCORE_LAUNCHES = 0

#: the kernel's table sizes (csrc/tube_corr.cu)
MAX_SIGMAS = 8
MAX_LINE_SAMPLES = 16


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


def vol_dims(field_shape) -> Tuple[int, int, int]:
    """True (Z, Y, X) volume dims of a packed (S, Z, Y, 3X) field."""
    _, l, h, w3 = (int(d) for d in field_shape)
    return l, h, w3 // 3


# -- the plain chain ------------------------------------------------------


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


def rel_coords(tables: TubeTables, vdims, pdims, corner, pos, dirs, g0, g1) -> torch.Tensor:
    """(T, g1-g0, N*NV, 4) rows (rz, ry, rx, 0): the samples p + v*dir of
    sigmas [g0, g1), clamped to the volume, then into the (pz, py, px)
    window at `corner` (T, 3) zyx; rz is 0 on a one-plane volume."""
    l, h, w = vdims
    pz, py, px = pdims
    t, n = pos.shape[:2]
    nv = tables.vgrid.shape[1]
    vg = tables.vgrid[g0:g1]
    pts = pos[:, :, None, None, :] + vg[None, None, :, :, None] * dirs[:, :, None, None, :]
    pts = pts.permute(0, 2, 1, 3, 4).reshape(t, g1 - g0, n * nv, 3)
    cf = corner.to(torch.float32)[:, None, None, :]
    rx = torch.clamp(torch.clamp(pts[..., 0], 0.0, w - 1.001) - cf[..., 2], 0.0, px - 1.001)
    ry = torch.clamp(torch.clamp(pts[..., 1], 0.0, h - 1.001) - cf[..., 1], 0.0, py - 1.001)
    if l == 1:
        rz = torch.zeros_like(rx)
    else:
        rz = torch.clamp(torch.clamp(pts[..., 2], 0.0, l - 1.001) - cf[..., 0], 0.0, pz - 1.001)
    return torch.stack([rz, ry, rx, torch.zeros_like(rx)], dim=-1)


def finish(tables: TubeTables, v: torch.Tensor, t: int, n: int):
    """(T, S, N*NV, 3) sample values -> (corr, sig) (T, N) and the masked
    line sums (T, N, S, 3)."""
    s, nv = tables.vgrid.shape
    v = v.reshape(t, s, n, nv, 3)
    sums = (v * tables.vmask[None, :, None, :, None]).sum(dim=3)  # (T, S, N, 3)
    s1, s2, s3 = (sums[..., c].permute(0, 2, 1) for c in range(3))
    corr, sig = corr_from_sums(tables, s1, s2, s3)
    return corr, sig, sums.permute(0, 2, 1, 3)


def _hat(q: torch.Tensor, p: int) -> torch.Tensor:
    """(..., R) coordinates -> (..., R, p) weights max(0, 1 - |q - k|)."""
    k = torch.arange(p, dtype=torch.float32, device=q.device)
    return torch.clamp(1.0 - torch.abs(q[..., None] - k), min=0.0)


def hat_sample_patch_plain(patches: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Hat samples of float32 windows (T, Sg, pz, py, 3*px) at rows rel
    (T, Sg, R, 4) -> (T, Sg, R, 4), (v_m1, v_m2, v_m3, 0): one (R, pz*py)
    @ (pz*py, 3*px) product per (trace, sigma) with the combined z/y hat
    weights, then the x hats (the JAX engine's XLA hat-einsum)."""
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


def hat_sample_field_plain(maps, corners, rel, pdims) -> torch.Tensor:
    """Hat samples of the field (S, Z, Y, 3X) in one (pz, py, px) window
    per trace at `corners` (T, 3) zyx, rows rel (T, S*Mr, 4) (row block s
    samples sigma s) -> (T, S*Mr, 4): the windows sliced out (widened to
    float32), then `hat_sample_patch_plain`."""
    s = int(maps.shape[0])
    t, rows = int(rel.shape[0]), int(rel.shape[1])
    patches = slice_windows(maps, corners, pdims).to(torch.float32)
    out = hat_sample_patch_plain(patches, rel.reshape(t, s, rows // s, 4))
    return out.reshape(t, rows, 4)


def tube_corr_plain(field, groups, corners, pos, dirs, tables: TubeTables, frame=None):
    """The plain version of `tube_corr`: per window group, slice, sample
    (`hat_sample_field_plain` on the group's sigmas), then `finish`.
    Returns (corr, sig) (T, N) and the line sums (T, N, S, 3). With a
    `frame` (ops/slab.SlabFrame) the field is a slab of a larger volume:
    positions and corners are in the larger volume's coordinates, samples
    clamp to its bounds, and the windows are read from the slab."""
    vdims = vol_dims(field.shape) if frame is None else tuple(frame.dims)
    t, n = pos.shape[:2]
    vs = []
    for g, (g0, g1, pdims) in enumerate(groups):
        corner = corners[:, g]
        rel = rel_coords(tables, vdims, pdims, corner, pos, dirs, g0, g1)
        gs, m = g1 - g0, rel.shape[2]
        local = corner if frame is None else frame.local(corner)
        v = hat_sample_field_plain(field[g0:g1], local, rel.reshape(t, gs * m, 4), pdims)
        vs.append(v.reshape(t, gs, m, 4)[..., :3])
    return finish(tables, vs[0] if len(vs) == 1 else torch.cat(vs, dim=1), t, n)


# -- the kernel -------------------------------------------------------------


class TubeParams(ctypes.Structure):
    """csrc/tube_corr.cu's `TubeParams`, member for member."""

    _fields_ = [
        ("S", ctypes.c_int32), ("NV", ctypes.c_int32), ("G", ctypes.c_int32),
        ("dims", ctypes.c_int32 * 3),
        ("origin", ctypes.c_int32 * 3),
        ("fdims", ctypes.c_int32 * 3),
        ("group_of", ctypes.c_int32 * MAX_SIGMAS),
        ("win", (ctypes.c_int32 * 3) * MAX_SIGMAS),
        ("win_hi", (ctypes.c_float * 3) * MAX_SIGMAS),
        ("vol_hi", ctypes.c_float * 3),
        ("flt_min", ctypes.c_float),
        ("vgrid", (ctypes.c_float * MAX_LINE_SAMPLES) * MAX_SIGMAS),
        ("vmask", (ctypes.c_float * MAX_LINE_SAMPLES) * MAX_SIGMAS),
    ] + [(name, ctypes.c_float * MAX_SIGMAS)
         for name in ("alpha1", "alpha2", "gbar", "n", "corrc", "sigmas")]


class KernelParams:
    """The kernel's constants for one window table and volume shape, copied
    to `device` once (`data`, the struct's bytes; the kernel reads them by
    pointer), with what the wrapper checks its inputs against. A field
    that is a slab of the volume `vdims` passes its place in it: `origin`
    (zyx) and its own (Z, Y, X) `field_dims` (ops/slab.SlabFrame)."""

    __slots__ = ("struct", "data", "address", "device_index", "field_shape", "groups")

    def __init__(self, tables: TubeTables, groups, vdims, device, origin=(0, 0, 0),
                 field_dims=None):
        field_dims = tuple(vdims) if field_dims is None else tuple(field_dims)
        s, nv = (int(d) for d in tables.vgrid.shape)
        if s > MAX_SIGMAS or nv > MAX_LINE_SAMPLES or not groups:
            raise ValueError(
                f"tube_corr takes at most {MAX_SIGMAS} sigmas of at most {MAX_LINE_SAMPLES} "
                f"line samples, got {s} of {nv}"
            )
        p = TubeParams()
        p.S, p.NV, p.G = s, nv, len(groups)
        for i, d in enumerate(vdims):
            p.dims[i] = d
            p.origin[i] = origin[i]
            p.fdims[i] = field_dims[i]
            p.vol_hi[i] = float(np.float32(d - 1.001))
        covered = []
        for g, (g0, g1, pdims) in enumerate(groups):
            # a window is >= 2 in every dimension, but for pz = 1 on a
            # one-plane volume
            if min(pdims[1:]) < 2 or pdims[0] < (1 if vdims[0] == 1 else 2):
                raise ValueError(f"tube_corr needs every window dimension >= 2 (pz = 1 only on a "
                                 f"one-plane volume), got {tuple(pdims)} in {tuple(vdims)}")
            if any(pd > d for pd, d in zip(pdims, vdims)) or any(
                    pd > d for pd, d in zip(pdims, field_dims)):
                raise ValueError(f"window {tuple(pdims)} exceeds the volume {tuple(vdims)} or "
                                 f"the field {field_dims}")
            for i, pd in enumerate(pdims):
                p.win[g][i] = pd
                p.win_hi[g][i] = float(np.float32(pd - 1.001))
            for si in range(g0, g1):
                p.group_of[si] = g
            covered.extend(range(g0, g1))
        if covered != list(range(s)):
            raise ValueError(f"the window groups {groups} do not cover sigmas 0..{s - 1} in order")
        p.flt_min = float(np.float32(_FLT_MIN))
        host = {k: v.detach().cpu().numpy() for k, v in tables._asdict().items()}
        for si in range(s):
            for v in range(nv):
                p.vgrid[si][v] = float(host["vgrid"][si, v])
                p.vmask[si][v] = float(host["vmask"][si, v])
            for name in ("alpha1", "alpha2", "gbar", "n", "corrc", "sigmas"):
                getattr(p, name)[si] = float(host[name][si])
        self.struct = p
        self.data = torch.frombuffer(bytearray(p), dtype=torch.uint8).to(device)
        self.address = self.data.data_ptr()
        self.device_index = self.data.get_device()
        l, h, w = field_dims
        self.field_shape = (s, l, h, 3 * w)
        self.groups = len(groups)


_STRUCT_CHECKED = False


def _check_struct() -> None:
    """Raise unless the library's TubeParams has the size of this module's."""
    global _STRUCT_CHECKED
    size = cuda.library().pnr_tube_params_size()
    if size != ctypes.sizeof(TubeParams):
        raise RuntimeError(
            f"csrc/tube_corr.cu's TubeParams is {size} bytes, ops/tube_corr.py's "
            f"{ctypes.sizeof(TubeParams)}"
        )
    _STRUCT_CHECKED = True


def check_struct() -> None:
    """`_check_struct`, once a process (the kernel's first launch runs it;
    the tracer runs it ahead of a CUDA graph capture)."""
    if not _STRUCT_CHECKED:
        _check_struct()


def tube_corr(field, groups, corners, pos, dirs, tables: TubeTables, params: KernelParams = None,
              scoring: bool = False, with_sums: bool = False, frame=None):
    """Tube ZNCC of the queries pos, dirs (T, N, 3) xyz over the windows
    `groups` at `corners` (T, G, 3) of `field` -> (out, sums): out
    (2, T, N) holds corr (row 0) and the sigma of the maximum (row 1), sums
    (T, N, S, 3) the masked line sums (on a card only `with_sums`, else
    None). A CPU field runs `tube_corr_plain`; a CUDA field the kernel,
    counted in SCORE_LAUNCHES when `scoring`, else TRACE_LAUNCHES, with
    `params` built for these groups and `frame` (built here when not
    given). `frame` (ops/slab.SlabFrame): the field is a slab of a larger
    volume, in whose coordinates pos and corners are."""
    if field.is_cuda:
        if params is None:
            fdims = vol_dims(field.shape)
            params = (KernelParams(tables, groups, fdims, field.device) if frame is None else
                      KernelParams(tables, groups, frame.dims, field.device, frame.origin, fdims))
        return _tube_corr_cuda(field, corners, pos, dirs, params, scoring, with_sums)
    if field.device.type != "cpu":
        raise ValueError(f"tube_corr: the field is on {field.device}, neither a card nor the CPU")
    corr, sig, sums = tube_corr_plain(field, groups, corners, pos, dirs, tables, frame)
    return torch.stack([corr, sig]), sums


def _tube_corr_cuda(field, corners, pos, dirs, params: KernelParams, scoring=False,
                    with_sums=False):
    # one launch per likelihood evaluation: the checks read each tensor's
    # device, dtype, shape and contiguity once (get_device() is -1 on the CPU)
    global TRACE_LAUNCHES, SCORE_LAUNCHES
    dev = field.get_device()
    if dev < 0 or not (corners.get_device() == pos.get_device() == dirs.get_device()
                       == params.device_index == dev):
        raise ValueError("tube_corr: field, corners, pos and dirs must each be a CUDA tensor, "
                         "on the device of the kernel's constants")
    bf16 = field.dtype is torch.bfloat16
    if not (bf16 or field.dtype is torch.float32):
        raise TypeError(f"tube_corr: the field must be float32 or bfloat16, got {field.dtype}")
    if (corners.dtype is not torch.int32 or pos.dtype is not torch.float32
            or dirs.dtype is not torch.float32):
        raise TypeError("tube_corr: corners must be int32, pos and dirs float32")
    shape = pos.shape
    if (len(shape) != 3 or shape[2] != 3 or dirs.shape != shape
            or field.shape != params.field_shape
            or corners.shape != (shape[0], params.groups, 3)):
        raise ValueError(
            f"tube_corr: bad shapes: field {tuple(field.shape)} (want {params.field_shape}), "
            f"corners {tuple(corners.shape)} ({params.groups} groups), pos {tuple(shape)}, "
            f"dirs {tuple(dirs.shape)}"
        )
    if not (field.is_contiguous() and corners.is_contiguous() and pos.is_contiguous()
            and dirs.is_contiguous()):
        raise ValueError("tube_corr: field, corners, pos and dirs must be contiguous")
    check_struct()
    t, n = shape[0], shape[1]
    out = pos.new_empty((2, t, n))
    sums = pos.new_empty((t, n, params.field_shape[0], 3)) if with_sums else None
    ptr = out.data_ptr()
    err = cuda.library().pnr_tube_corr(
        field.data_ptr(), bf16, params.address, corners.data_ptr(), pos.data_ptr(),
        dirs.data_ptr(), t, n, ptr, ptr + 4 * t * n, None if sums is None else sums.data_ptr(),
        cuda.raw_stream(dev),
    )
    if err:
        cuda.check(err, "pnr_tube_corr")
    with cuda.COUNT_LOCK:
        if scoring:
            SCORE_LAUNCHES += 1
        else:
            TRACE_LAUNCHES += 1
    return out, sums
