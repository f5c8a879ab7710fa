"""K2: exact template ZNCC as a hand-written CUDA kernel (csrc/zncc_exact.cu).

Port of pnr_tpu/ops/zncc_exact.py (parity target `Tracker::znccBBB`,
pnr-vaa3d/tracker.cpp:1891-1964): `ExactPatchEngine` with its patch
geometry (`dims` / `corners` / `extract` / `qinfo`), the kernel wrapper
`exact_sums`, its plain PyTorch version `exact_sums_plain`, and
`exact_corr_from_sums`.

Each (trace, particle) query reduces to three sums per sigma:
A = sum(I - m0), B = sum((I - m0)^2), C = sum((I - m0) * g), with m0 the
volume value at the particle (a variance-preserving shift: without it
B - A^2/K cancels). Samples are clamped to the volume and to the
trace's patch, which is sized to the template reach + 3*step + 1 around
the particle cloud's mean, exactly as the JAX engine sizes it.

The CUDA kernel (csrc/zncc_exact.cu) runs one thread-block cluster per
trace: `slab_plan` cuts the trace's uint8 patch into z slabs that each
fit one block's shared memory, every block loads its slab once and
evaluates all of the call's queries of the trace from it, and the
cluster adds the blocks' partial sums in rank order. The plain version
cuts f32 patches (`extract`) and samples them with `trilinear`, the math
of `_exact_sums_xla`. A CPU tensor runs the plain version; a CUDA tensor
runs the kernel or raises.

`template_tables` sorts each sigma's template rows by (w, v, u), as the
TPU engine's `build_exact_bank` does: the template's u axis lies in the
xy plane, so rows that share (v, w) share a z coordinate, and a warp's
lanes read one z plane of the slab. Its 512-sample blocks with their
static windows are Mosaic layout and are not ported.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops.zncc_model import ZnccTemplates
from pnr_tpu_torch.ops import cuda
from pnr_tpu_torch.ops.interp import trilinear
from pnr_tpu_torch.ops.zncc import _FLT_MIN, local_frame

#: kernel launches through the CUDA route (one per call)
LAUNCHES = 0

# query columns (pnr_tpu/ops/zncc_exact.py _qinfo)
_Q_RZ, _Q_NDZ, _Q_WZ = 0, 1, 2
_Q_RY, _Q_NDY, _Q_WY = 3, 4, 5
_Q_RX, _Q_NDX, _Q_WX = 6, 7, 8
_Q_UY, _Q_UX = 9, 10
_Q_M0, _Q_ZHI, _Q_YHI, _Q_XHI = 11, 12, 13, 14
_QCOLS = 16

#: the plain version evaluates at most this many samples per chunk
_PLAIN_CHUNK = 1 << 23

#: a block's most dynamic shared memory on sm_90 (csrc/zncc_exact.cu: kMaxSmem)
SMEM_MAX = 232448
#: shared memory of the kernel's warp partials, 2 x (4 queries, 16 warps,
#: 3 sums) floats (csrc/zncc_exact.cu: kRedFloats)
_RED_BYTES = 2 * 4 * 16 * 3 * 4
#: error codes of pnr_exact_sums besides cudaError values
_ERR_UNSCHEDULABLE, _ERR_PLAN = -2, -3


def _roundup(v: int, m: int) -> int:
    return -(-v // m) * m


class TemplateTables(NamedTuple):
    """Per-sigma template samples as device tensors."""

    tab: torch.Tensor  # (S, Kmax, 4) float32 rows (v, u, w, g)
    cnt: torch.Tensor  # (S,) int32 sample counts
    cnt_f: torch.Tensor  # (S,) float32
    avg: torch.Tensor  # (S,) float32 template means
    corrc: torch.Tensor  # (S,) float32 template auto-correlation
    sigmas: torch.Tensor  # (S,) float32


def template_tables(templates: ZnccTemplates, device) -> TemplateTables:
    """The per-sigma template rows (v, u, w, g), each sigma's sorted by
    (w, v, u) (`build_exact_bank`'s order), on `device`."""
    tab = np.zeros((len(templates.sigmas), templates.kmax, 4), np.float32)
    for i in range(len(templates.sigmas)):
        k = int(templates.cnt[i])
        offs = templates.offs[i, :k]
        order = np.lexsort((offs[:, 1], offs[:, 0], offs[:, 2]))
        tab[i, :k, :3] = offs[order]
        tab[i, :k, 3] = templates.wgt[i, :k][order]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return TemplateTables(
        tab=t(tab),
        cnt=t(templates.cnt.astype(np.int32), torch.int32),
        cnt_f=t(templates.cnt),
        avg=t(templates.avg),
        corrc=t(templates.corrc),
        sigmas=t(np.asarray(templates.sigmas, np.float32)),
    )


class SlabPlan(NamedTuple):
    """The z slabs of a (pz, py, px) patch: slab i owns the sample floors
    z1 in [i*step, min((i+1)*step, pz-1)) and holds planes i*step ..
    min((i+1)*step, pz-1), one plane past what it owns; rows are `pitch`
    bytes in shared memory. A one-plane patch (pz == 1, a 2-D stack) has
    one slab with step 0: it holds the plane and owns floor 0, and its
    samples are bilinear in that plane."""

    nz: int
    step: int
    pitch: int

    def bounds(self, pz: int):
        """[(first owned floor, end of owned floors)] per slab."""
        if pz == 1:
            return [(0, 1)]
        return [(i * self.step, min((i + 1) * self.step, pz - 1)) for i in range(self.nz)]


def row_pitch(px: int) -> int:
    """Bytes per patch row in shared memory: a row is copied from the
    aligned 4-byte word at or below its first byte, so it needs px + 3
    bytes, rounded up to whole words."""
    return 4 * (-(-(px + 3) // 4))


def slab_plan(patch_shape, budget: int) -> SlabPlan:
    """Cut the patch into the fewest z slabs of at most `budget` bytes of
    shared memory each, as even as whole planes allow; a one-plane patch
    is one slab of one plane (one block a cluster)."""
    pz, py, px = (int(d) for d in patch_shape)
    if min(py, px) < 2 or pz < 1:
        raise ValueError(f"exact_sums needs py, px >= 2 and pz >= 1, got {(pz, py, px)}")
    pitch = row_pitch(px)
    if pz == 1:
        if py * pitch > int(budget):
            raise ValueError(f"the plane of the patch {(pz, py, px)} needs {py * pitch} bytes, "
                             f"the budget is {budget}")
        return SlabPlan(nz=1, step=0, pitch=pitch)
    planes = int(budget) // (py * pitch)
    if planes < 2:
        raise ValueError(
            f"a slab of the patch {(pz, py, px)} needs two planes of {py * pitch} bytes, "
            f"the budget is {budget}"
        )
    floors = pz - 1
    step = -(-floors // -(-floors // (planes - 1)))
    return SlabPlan(nz=-(-floors // step), step=step, pitch=pitch)


def smem_bytes(plan: SlabPlan, py: int, b: int, s: int) -> int:
    """The kernel's dynamic shared memory per block: the slab, the warp
    partials, the (B, S, 3) sums and the (B, 16) query columns
    (csrc/zncc_exact.cu: smem_bytes)."""
    return (_roundup((plan.step + 1) * py * plan.pitch, 16) + _RED_BYTES + 12 * b * s
            + 4 * _QCOLS * b)


@functools.lru_cache(maxsize=64)
def kernel_plan(patch_shape, b: int, s: int, budget: int = None) -> SlabPlan:
    """The kernel's slabs for B queries of S sigmas per trace: all of a
    block's shared memory that the partial sums and the query columns
    leave, or `budget`."""
    room = SMEM_MAX - _RED_BYTES - 12 * b * s - 4 * _QCOLS * b - 16
    return slab_plan(patch_shape, room if budget is None else min(int(budget), room))


def exact_sums(
    vol: torch.Tensor,
    corner: torch.Tensor,
    qs: torch.Tensor,
    tables: TemplateTables,
    patch_shape: Tuple[int, int, int],
    slab_budget: int = None,
) -> torch.Tensor:
    """(T, B, S, 4) sums [A, B, C, 0] for queries `qs` (T, B, 16) in the
    patches at `corner` (T, 3) zyx of the uint8 volume `vol`. On a card,
    `slab_budget` caps a slab's shared memory (more slabs per trace)."""
    if vol.device.type == "cpu":
        return exact_sums_plain(vol, corner, qs, tables, patch_shape)
    return _exact_sums_cuda(vol, corner, qs, tables, patch_shape, slab_budget)


def _exact_sums_cuda(vol, corner, qs, tables, patch_shape, slab_budget=None):
    # the checks read each tensor's device, dtype, rank and contiguity once
    # (get_device() is -1 on the CPU); the tables are built on one device by
    # template_tables
    global LAUNCHES
    dev = vol.get_device()
    tab, cnt = tables.tab, tables.cnt
    if dev < 0 or not (corner.get_device() == qs.get_device() == tab.get_device() == dev):
        raise ValueError(
            f"exact_sums: vol, corner, qs and the tables must be CUDA tensors on one device, "
            f"got {vol.device}, {corner.device}, {qs.device}, {tab.device}"
        )
    if (vol.dtype is not torch.uint8 or corner.dtype is not torch.int32
            or qs.dtype is not torch.float32 or tab.dtype is not torch.float32
            or cnt.dtype is not torch.int32):
        raise TypeError(
            f"exact_sums: vol must be uint8, corner int32, qs and tables.tab float32, "
            f"tables.cnt int32; got {vol.dtype}, {corner.dtype}, {qs.dtype}, {tab.dtype}, "
            f"{cnt.dtype}"
        )
    shape = qs.shape
    if (vol.dim() != 3 or len(shape) != 3 or shape[2] != _QCOLS
            or corner.shape != (shape[0], 3) or tab.dim() != 3 or tab.shape[2] != 4):
        raise ValueError(
            f"exact_sums: bad shapes: vol {tuple(vol.shape)}, qs {tuple(shape)}, corner "
            f"{tuple(corner.shape)}, tab {tuple(tab.shape)}"
        )
    if not (vol.is_contiguous() and corner.is_contiguous() and qs.is_contiguous()):
        raise ValueError("exact_sums: vol, corner and qs must be contiguous")
    t, b = shape[0], shape[1]
    s, kmax = tab.shape[0], tab.shape[1]
    pz, py, px = patch_shape
    plan = kernel_plan(tuple(patch_shape), b, s, slab_budget)
    z, y, x = vol.shape
    out = qs.new_empty((t, b, s, 4))
    err = cuda.library().pnr_exact_sums(
        vol.data_ptr(), z, y, x, corner.data_ptr(), qs.data_ptr(), t, b, tab.data_ptr(),
        cnt.data_ptr(), s, kmax, pz, py, px, plan.nz, plan.step, plan.pitch, out.data_ptr(),
        cuda.raw_stream(dev),
    )
    if err:
        _raise(err, vol, patch_shape, plan, b, s)
    with cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out


def prepare_launch(vol: torch.Tensor, patch_shape, b: int, s: int, slab_budget: int = None):
    """Set up K2's launch state for B queries of S sigmas in patches of
    `patch_shape` of the CUDA volume `vol`, without launching: the
    kernel's shared-memory limit and the check that its cluster can be
    scheduled, as the first launch of that plan would. A CUDA graph
    capture must find this state in place (smc/graphs.py)."""
    plan = kernel_plan(tuple(patch_shape), b, s, slab_budget)
    pz, py, px = patch_shape
    with torch.cuda.device(vol.device):
        err = cuda.library().pnr_exact_sums_prepare(b, s, pz, py, px, plan.nz, plan.step,
                                                    plan.pitch)
    if err:
        _raise(err, vol, patch_shape, plan, b, s)


def _raise(err, vol, patch_shape, plan, b, s):
    what = (f"volume {tuple(vol.shape)}, patch {tuple(patch_shape)}, {plan.nz} slabs of "
            f"{plan.step} floors, pitch {plan.pitch}, B={b}, S={s}, "
            f"{smem_bytes(plan, patch_shape[1], b, s)} bytes of shared memory per block")
    if err == _ERR_UNSCHEDULABLE:
        raise RuntimeError(f"pnr_exact_sums: a cluster of {min(plan.nz, 8)} blocks cannot be "
                           f"scheduled on this card: {what}")
    if err == _ERR_PLAN:
        raise ValueError(f"pnr_exact_sums: the kernel refused the slab plan: {what}")
    cuda.check(err, f"pnr_exact_sums ({what})")


def extract(vol: torch.Tensor, corner: torch.Tensor, patch_shape) -> torch.Tensor:
    """(T, pz, py, px) float32 patches of `vol` at `corner` (T, 3) zyx."""
    pz, py, px = patch_shape
    dev = vol.device
    c = corner.long()
    iz = c[:, 0, None] + torch.arange(pz, device=dev)
    iy = c[:, 1, None] + torch.arange(py, device=dev)
    ix = c[:, 2, None] + torch.arange(px, device=dev)
    return vol[iz[:, :, None, None], iy[:, None, :, None], ix[:, None, None, :]].to(
        torch.float32
    )


def sample_coords(q, tv, tu, tw):
    """The clamped patch-frame coordinates (rz, ry, rx), each (..., K), of
    the template rows (tv, tu, tw) (K,) for query columns `q` (..., 16, 1).
    The floor at 0 is K2's `fmaxf`: a NaN coordinate (the query of a dead
    lane whose carry has none) samples the patch's first element, where
    a clamp would pass the NaN on to an index."""

    def col(i):
        return q[..., i, :]

    zero = q.new_zeros(())
    rz = torch.minimum(torch.fmax(col(_Q_RZ) + tv * col(_Q_NDZ) + tw * col(_Q_WZ), zero),
                       col(_Q_ZHI))
    ry = torch.minimum(
        torch.fmax(col(_Q_RY) + tv * col(_Q_NDY) + tu * col(_Q_UY) + tw * col(_Q_WY), zero),
        col(_Q_YHI),
    )
    rx = torch.minimum(
        torch.fmax(col(_Q_RX) + tv * col(_Q_NDX) + tu * col(_Q_UX) + tw * col(_Q_WX), zero),
        col(_Q_XHI),
    )
    return rz, ry, rx


def plain_samples(vol, corner, qs, tables, patch_shape):
    """The plain version's template samples, chunk by chunk: yields (si,
    t0, vals (n, B, K) float32 of I - m0, rz (n, B, K) the clamped
    patch-frame z, tg (K,) the weights) for sigma si and traces t0 ..
    t0+n-1, the math of `_exact_sums_xla`."""
    patches = extract(vol, corner, patch_shape)
    t, b = int(qs.shape[0]), int(qs.shape[1])
    counts = tables.cnt.tolist()
    for si in range(int(tables.tab.shape[0])):
        k = int(counts[si])
        tv, tu, tw, tg = tables.tab[si, :k].unbind(-1)
        tc = max(1, _PLAIN_CHUNK // max(1, b * k))
        for t0 in range(0, t, tc):
            rz, ry, rx = sample_coords(qs[t0 : t0 + tc, :, :, None], tv, tu, tw)
            n = rz.shape[0]
            vals = trilinear(
                patches[t0 : t0 + n], rx.reshape(n, -1), ry.reshape(n, -1), rz.reshape(n, -1)
            ).reshape(n, b, k) - qs[t0 : t0 + n, :, _Q_M0, None]
            yield si, t0, vals, rz, tg


def exact_sums_plain(vol, corner, qs, tables, patch_shape) -> torch.Tensor:
    """Plain PyTorch version of K2: the `_exact_sums_xla` math on f32
    patches cut with `extract`, sampled with `trilinear`."""
    t, b = int(qs.shape[0]), int(qs.shape[1])
    out = torch.zeros((t, b, int(tables.tab.shape[0]), 4), dtype=torch.float32, device=vol.device)
    for si, t0, vals, _, tg in plain_samples(vol, corner, qs, tables, patch_shape):
        n = vals.shape[0]
        out[t0 : t0 + n, :, si, 0] = vals.sum(-1)
        out[t0 : t0 + n, :, si, 1] = (vals * vals).sum(-1)
        out[t0 : t0 + n, :, si, 2] = (vals * tg).sum(-1)
    return out


def exact_corr_from_sums(tables: TemplateTables, sums: torch.Tensor):
    """(T, B, S, 4) sums [A, B, C, _] -> (corr (T, B), sig (T, B)).

    corra = C - gavg*A and corrb = B - A^2/K are invariant to the m0
    shift (znccBBB, tracker.cpp:1936-1955). A later sigma wins only on a
    strictly greater correlation, as in the reference."""
    a, b, c = sums[..., 0], sums[..., 1], sums[..., 2]
    corra = c - tables.avg * a
    corrb = torch.clamp(b - (a * a) / tables.cnt_f, min=0.0)
    denom = corrb * tables.corrc
    corrs = torch.where(
        denom > _FLT_MIN,
        corra / torch.sqrt(torch.clamp(denom, min=_FLT_MIN)),
        torch.zeros_like(denom),
    )
    best_corr = torch.full(corrs.shape[:-1], -math.inf, dtype=torch.float32, device=sums.device)
    best_sig = torch.ones(corrs.shape[:-1], dtype=torch.float32, device=sums.device)
    for si in range(corrs.shape[-1]):
        take = corrs[..., si] > best_corr
        best_corr = torch.where(take, corrs[..., si], best_corr)
        best_sig = torch.where(take, tables.sigmas[si], best_sig)
    return best_corr, best_sig


class ExactPatchEngine:
    """Per-trace-patch exact ZNCC evaluator for a template set.

    corners(vol_shape, center (T, 3) xyz) -> corner (T, 3) zyx int32
    corr(vol, corner, pos (T, B, 3), dirs) -> (corr (T, B), sig (T, B))
    eval_fused(vol, pos, dirs): both, with the patch centred on the mean
    of each trace's queries.

    Each takes an optional `frame` (ops/slab.SlabFrame): `vol` is then a
    slab of a larger volume, positions and corners are in the larger
    volume's coordinates, patches are placed and samples clamped as there,
    and the patch is read from the slab (shifted into it if it would
    leave it).
    """

    def __init__(
        self, templates: ZnccTemplates, step: float, device,
        tables: TemplateTables = None,
    ):
        self.is2d = templates.is2d
        self.tables = tables if tables is not None else template_tables(templates, device)
        # patch reach (build_exact_bank): template extent upper bounds
        rz_max = rxy_max = 1.0
        for i in range(len(templates.sigmas)):
            offs = templates.offs[i, : int(templates.cnt[i])]
            v2 = float(np.abs(offs[:, 0]).max())
            u2 = float(np.abs(offs[:, [1, 2]]).max())
            rz_max = max(rz_max, math.sqrt(v2 * v2 + u2 * u2))
            rxy_max = max(rxy_max, v2 + math.sqrt(2.0) * u2)
        self.reach_z = int(math.ceil(rz_max)) + 1
        self.reach_xy = int(math.ceil(rxy_max)) + 1
        self.allow = int(math.ceil(3.0 * float(step))) + 1

    def dims(self, vol_shape) -> Tuple[int, int, int]:
        """Patch (pz, py, px); py keeps the JAX engine's multiple of 8 so
        both packages cut the same patches; one plane on a 2-D stack."""
        l, h, w = vol_shape[-3:]
        half_xy = self.allow + self.reach_xy
        half_z = self.allow + self.reach_z
        py = min(_roundup(2 * half_xy + 2, 8), h)
        px = min(2 * half_xy + 2, w)
        pz = 1 if l == 1 else min(2 * half_z + 2, l)
        return pz, py, px

    def corners(self, vol_shape, center: torch.Tensor, frame=None) -> torch.Tensor:
        if frame is not None:
            corner = self.corners(frame.dims, center)
            return frame.into(corner, self.dims(frame.dims), vol_shape[-3:])
        l, h, w = vol_shape[-3:]
        pz, py, px = self.dims(vol_shape)
        c = torch.round(center).to(torch.int32)
        cx = torch.clamp(c[:, 0] - px // 2, 0, w - px)
        cy = torch.clamp(c[:, 1] - py // 2, 0, max(h - py, 0))
        cz = torch.clamp(c[:, 2] - pz // 2, 0, l - pz)
        return torch.stack([cz, cy, cx], dim=-1).contiguous()

    def patch_dims(self, vol, frame=None) -> Tuple[int, int, int]:
        """The patch of `vol`, or of the volume that `frame` places it in;
        it must fit `vol`."""
        if frame is None:
            return self.dims(vol.shape)
        pdims = self.dims(frame.dims)
        if any(p > d for p, d in zip(pdims, vol.shape)):
            raise ValueError(f"a patch {pdims} does not fit the slab {tuple(vol.shape)}")
        return pdims

    def qinfo(self, vol, corner, pos, dirs, frame=None) -> torch.Tensor:
        """Pack per-(trace, particle) frame/position/bounds scalars (T, B, 16)."""
        l, h, w = (int(d) for d in (vol.shape if frame is None else frame.dims))
        pz, py, px = self.patch_dims(vol, frame)
        vx, vy, vz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        u, wv = local_frame(vx, vy, vz, self.is2d)
        cf = corner.to(torch.float32)
        rzp = pos[..., 2] - cf[:, None, 0]
        ryp = pos[..., 1] - cf[:, None, 1]
        rxp = pos[..., 0] - cf[:, None, 2]
        zhi = torch.clamp((l - 1.001) - cf[:, 0], max=pz - 1.001)[:, None]
        yhi = torch.clamp((h - 1.001) - cf[:, 1], max=py - 1.001)[:, None]
        xhi = torch.clamp((w - 1.001) - cf[:, 2], max=px - 1.001)[:, None]
        if l == 1:
            # one plane: every sample lies in it (JAX's _qinfo)
            rzp = torch.zeros_like(rzp)
            zhi = torch.zeros_like(zhi)
        # m0: the volume value at the particle, inside its patch
        ci = (corner if frame is None else frame.local(corner)).long()
        vh, vw = int(vol.shape[1]), int(vol.shape[2])
        pzi = torch.clamp(torch.round(rzp).long(), 0, pz - 1) + ci[:, None, 0]
        pyi = torch.clamp(torch.round(ryp).long(), 0, py - 1) + ci[:, None, 1]
        pxi = torch.clamp(torch.round(rxp).long(), 0, px - 1) + ci[:, None, 2]
        m0 = vol.reshape(-1)[(pzi * vh + pyi) * vw + pxi].to(torch.float32)
        return torch.stack(
            [
                rzp, -vz, wv[..., 2],
                ryp, -vy, wv[..., 1],
                rxp, -vx, wv[..., 0],
                u[..., 1], u[..., 0],
                m0, zhi.expand_as(m0), yhi.expand_as(m0), xhi.expand_as(m0),
                torch.zeros_like(m0),
            ],
            dim=-1,
        ).contiguous()

    def corr(self, vol, corner, pos, dirs, frame=None):
        qs = self.qinfo(vol, corner, pos, dirs, frame)
        local = corner if frame is None else frame.local(corner)
        sums = exact_sums(vol, local, qs, self.tables, self.patch_dims(vol, frame))
        return exact_corr_from_sums(self.tables, sums)

    def eval_fused(self, vol, pos, dirs, frame=None):
        corner = self.corners(vol.shape, pos.mean(dim=1), frame)
        return self.corr(vol, corner, pos, dirs, frame)

    def prepare(self, vol, b: int, frame=None) -> None:
        """K2's launch state for this volume's patches (those of the volume
        `frame` places it in) at B = b queries a trace and at B = 1 (the
        tracer's particles and its centroid), set up ahead of a CUDA graph
        capture (`prepare_launch`); nothing on the CPU."""
        if vol.is_cuda:
            s = int(self.tables.tab.shape[0])
            for q in sorted({1, int(b)}):
                prepare_launch(vol, self.patch_dims(vol, frame), q, s)
