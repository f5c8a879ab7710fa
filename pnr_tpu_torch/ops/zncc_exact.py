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

The CUDA kernel samples the uint8 volume in device memory at
corner + floor(rel) and never materialises patches; the plain version
cuts f32 patches (`extract`) and samples them with `trilinear`, the math
of `_exact_sums_xla`. A CPU tensor runs the plain version; a CUDA tensor
runs the kernel or raises.

The TPU engine's z-sorted 512-sample blocks with their static windows
(`build_exact_bank`) are Mosaic layout and are not ported: the kernel
reads the plain per-sigma template of `ZnccTemplates`.
"""

from __future__ import annotations

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
    tab = np.concatenate(
        [templates.offs, templates.wgt[..., None]], axis=-1
    ).astype(np.float32)

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


def exact_sums(
    vol: torch.Tensor,
    corner: torch.Tensor,
    qs: torch.Tensor,
    tables: TemplateTables,
    patch_shape: Tuple[int, int, int],
) -> torch.Tensor:
    """(T, B, S, 4) sums [A, B, C, 0] for queries `qs` (T, B, 16) in the
    patches at `corner` (T, 3) zyx of the uint8 volume `vol`."""
    if vol.device.type == "cpu":
        return exact_sums_plain(vol, corner, qs, tables, patch_shape)
    return _exact_sums_cuda(vol, corner, qs, tables)


def _exact_sums_cuda(vol, corner, qs, tables):
    global LAUNCHES
    cuda.require_cuda_tensor(vol, "vol", torch.uint8, 3)
    cuda.require_cuda_tensor(corner, "corner", torch.int32, 2)
    cuda.require_cuda_tensor(qs, "qs", torch.float32, 3)
    cuda.require_cuda_tensor(tables.tab, "tables.tab", torch.float32, 3)
    cuda.require_cuda_tensor(tables.cnt, "tables.cnt", torch.int32, 1)
    t, b, cols = (int(s) for s in qs.shape)
    s, kmax = int(tables.tab.shape[0]), int(tables.tab.shape[1])
    if cols != _QCOLS or tuple(corner.shape) != (t, 3) or tables.tab.shape[2] != 4:
        raise ValueError(
            f"bad shapes: qs {tuple(qs.shape)}, corner {tuple(corner.shape)}, "
            f"tab {tuple(tables.tab.shape)}"
        )
    for name, x in (("corner", corner), ("qs", qs), ("tables.tab", tables.tab)):
        if x.device != vol.device:
            raise ValueError(f"{name} is on {x.device}, vol on {vol.device}")
    z, y, x = (int(d) for d in vol.shape)
    out = torch.empty((t, b, s, 4), dtype=torch.float32, device=vol.device)
    cuda.check(
        cuda.library().pnr_exact_sums(
            vol.data_ptr(), z, y, x, corner.data_ptr(), qs.data_ptr(), t, b,
            tables.tab.data_ptr(), tables.cnt.data_ptr(), s, kmax, out.data_ptr(),
            cuda.stream_of(vol),
        ),
        "pnr_exact_sums",
    )
    LAUNCHES += 1
    return out


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


def exact_sums_plain(vol, corner, qs, tables, patch_shape) -> torch.Tensor:
    """Plain PyTorch version of K2: the `_exact_sums_xla` math on f32
    patches cut with `extract`, sampled with `trilinear`."""
    patches = extract(vol, corner, patch_shape)
    t, b = int(qs.shape[0]), int(qs.shape[1])
    s_count = int(tables.tab.shape[0])
    out = torch.zeros((t, b, s_count, 4), dtype=torch.float32, device=vol.device)
    counts = tables.cnt.tolist()
    for si in range(s_count):
        k = int(counts[si])
        tv, tu, tw, tg = tables.tab[si, :k].unbind(-1)
        tc = max(1, _PLAIN_CHUNK // max(1, b * k))
        for t0 in range(0, t, tc):
            q = qs[t0 : t0 + tc, :, :, None]  # (tc, B, 16, 1)

            def col(i):
                return q[:, :, i]  # (tc, B, 1)

            rz = torch.minimum(
                torch.clamp(col(_Q_RZ) + tv * col(_Q_NDZ) + tw * col(_Q_WZ), min=0.0),
                col(_Q_ZHI),
            )
            ry = torch.minimum(
                torch.clamp(
                    col(_Q_RY) + tv * col(_Q_NDY) + tu * col(_Q_UY) + tw * col(_Q_WY),
                    min=0.0,
                ),
                col(_Q_YHI),
            )
            rx = torch.minimum(
                torch.clamp(
                    col(_Q_RX) + tv * col(_Q_NDX) + tu * col(_Q_UX) + tw * col(_Q_WX),
                    min=0.0,
                ),
                col(_Q_XHI),
            )
            n = rz.shape[0]
            vals = trilinear(
                patches[t0 : t0 + n], rx.reshape(n, -1), ry.reshape(n, -1), rz.reshape(n, -1)
            ).reshape(n, b, k) - col(_Q_M0)
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
    """

    def __init__(
        self, templates: ZnccTemplates, step: float, device,
        tables: TemplateTables = None,
    ):
        if templates.is2d:
            raise NotImplementedError(
                "2-D stacks are not ported yet (ROADMAP.md, port queue: 2-D)"
            )
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
        both packages cut the same patches."""
        l, h, w = vol_shape[-3:]
        half_xy = self.allow + self.reach_xy
        half_z = self.allow + self.reach_z
        py = min(_roundup(2 * half_xy + 2, 8), h)
        px = min(2 * half_xy + 2, w)
        pz = min(2 * half_z + 2, l)
        return pz, py, px

    def corners(self, vol_shape, center: torch.Tensor) -> torch.Tensor:
        l, h, w = vol_shape[-3:]
        pz, py, px = self.dims(vol_shape)
        c = torch.round(center).to(torch.int32)
        cx = torch.clamp(c[:, 0] - px // 2, 0, w - px)
        cy = torch.clamp(c[:, 1] - py // 2, 0, max(h - py, 0))
        cz = torch.clamp(c[:, 2] - pz // 2, 0, l - pz)
        return torch.stack([cz, cy, cx], dim=-1).contiguous()

    def qinfo(self, vol, corner, pos, dirs) -> torch.Tensor:
        """Pack per-(trace, particle) frame/position/bounds scalars (T, B, 16)."""
        l, h, w = (int(d) for d in vol.shape)
        pz, py, px = self.dims(vol.shape)
        vx, vy, vz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        u, wv = local_frame(vx, vy, vz, False)
        cf = corner.to(torch.float32)
        rzp = pos[..., 2] - cf[:, None, 0]
        ryp = pos[..., 1] - cf[:, None, 1]
        rxp = pos[..., 0] - cf[:, None, 2]
        zhi = torch.clamp((l - 1.001) - cf[:, 0], max=pz - 1.001)[:, None]
        yhi = torch.clamp((h - 1.001) - cf[:, 1], max=py - 1.001)[:, None]
        xhi = torch.clamp((w - 1.001) - cf[:, 2], max=px - 1.001)[:, None]
        # m0: the volume value at the particle, inside its patch
        ci = corner.long()
        pzi = torch.clamp(torch.round(rzp).long(), 0, pz - 1) + ci[:, None, 0]
        pyi = torch.clamp(torch.round(ryp).long(), 0, py - 1) + ci[:, None, 1]
        pxi = torch.clamp(torch.round(rxp).long(), 0, px - 1) + ci[:, None, 2]
        m0 = vol.reshape(-1)[(pzi * h + pyi) * w + pxi].to(torch.float32)
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

    def corr(self, vol, corner, pos, dirs):
        qs = self.qinfo(vol, corner, pos, dirs)
        sums = exact_sums(vol, corner, qs, self.tables, self.dims(vol.shape))
        return exact_corr_from_sums(self.tables, sums)

    def eval_fused(self, vol, pos, dirs):
        corner = self.corners(vol.shape, pos.mean(dim=1))
        return self.corr(vol, corner, pos, dirs)
