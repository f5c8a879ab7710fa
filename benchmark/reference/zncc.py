"""Plain ZNCC likelihoods of the tracer: exact templates and the tube approximation.

Both follow the upstream tracker's znccBBB (pnr-vaa3d/tracker.cpp) in
plain torch operations, built here from the published recipe and nothing
of the program under test.

Exact: per sigma s a lattice of offsets (v, u, w), v in -round(s)..round(s)
and u, w in -round(3s)..round(3s) at the pitch max(1, 3s / 12), weights
exp(-(u^2 + w^2) / 2 s^2); a query at p with direction d samples the stack
trilinearly at p - v d + u U + w W, (U, W) the tracker's frame of d, and
its correlation is sum(dv dw) / sqrt(sum(dv^2) sum(dw^2)) of the samples
and weights less their means; the best sigma wins (the earliest on ties).

Tube: the template does not vary along its axis, so the three sums become
line sums along d through three maps a sigma: M1 the stack correlated with
exp(-t^2 / 2 s^2) (half-width ceil(3s)), M2 the stack and M3 its square
correlated with a box of half-width round(3s), each along x, y and z with
replicated borders; the line samples p + v d at the template's v values;
corr = (a1 S1 - g a2 S2) / sqrt((a2 S3 - (a2 S2)^2 / N) C), with a1 scaling
M1's sum to the template's weight sum, a2 the template's share of the box,
g the template mean, N its sample count and C its sum of squared
deviations.

Sampling clamps coordinates to [0, dim - 1.001], as the tracker's interp.
Sample values and sums are in `dtype`; coordinates stay float32.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from benchmark.reference.frangi import correlate1d

_TINY = 1.175494e-38


def _range(half: int, pitch: float) -> np.ndarray:
    n = int(math.floor((2.0 * half) / pitch + 1e-6)) + 1
    return (-half + np.arange(n) * pitch).astype(np.float32)


def _grids(sig: float):
    pitch = max(1.0, 3.0 * sig / 12.0)
    return _range(int(round(sig)), pitch), _range(int(round(3.0 * sig)), pitch)


def frame(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tracker's (U, W) for unit directions d (N, 3); W keeps the
    upstream sign convention (its y component flipped against U x d)."""
    vx, vy, vz = d[:, 0], d[:, 1], d[:, 2]
    nrm = torch.sqrt(vx * vx + vy * vy)
    planar = nrm > 1e-4
    safe = torch.where(planar, nrm, torch.ones_like(nrm))
    sg = torch.where(vy < 0, -torch.ones_like(vy), torch.ones_like(vy))
    ux = torch.where(planar, sg * vy / safe, torch.ones_like(vy))
    uy = torch.where(planar, -sg * vx / safe, torch.zeros_like(vx))
    uz = torch.zeros_like(ux)
    u = torch.stack([ux, uy, uz], 1)
    w = torch.stack([uy * vz - uz * vy, -ux * vz + uz * vx, ux * vy - uy * vx], 1)
    return u, w


def sample(vol: torch.Tensor, pts: torch.Tensor, dtype) -> torch.Tensor:
    """Trilinear samples of `vol` (Z, Y, X) at pts (..., 3) xyz, in `dtype`."""
    l, h, w = vol.shape
    x = pts[..., 0].clamp(0.0, w - 1.001)
    y = pts[..., 1].clamp(0.0, h - 1.001)
    z = pts[..., 2].clamp(0.0, l - 1.001)
    x0, y0, z0 = x.floor(), y.floor(), z.floor()
    fx, fy, fz = (x - x0).to(dtype), (y - y0).to(dtype), (z - z0).to(dtype)
    i = (z0.long() * h + y0.long()) * w + x0.long()
    flat = vol.reshape(-1)

    def at(o):
        return flat[i + o].to(dtype)

    p0 = (1 - fy) * ((1 - fx) * at(0) + fx * at(1)) + fy * ((1 - fx) * at(w) + fx * at(w + 1))
    hw = h * w
    p1 = ((1 - fy) * ((1 - fx) * at(hw) + fx * at(hw + 1))
          + fy * ((1 - fx) * at(hw + w) + fx * at(hw + w + 1)))
    return (1 - fz) * p0 + fz * p1


class Exact:
    """znccBBB over the uint8 stack."""

    def __init__(self, sigmas, dtype=torch.float32, chunk: int = 2048):
        self.sigmas = [float(s) for s in sigmas]
        self.dtype, self.chunk = dtype, chunk
        self.tpl = []
        for s in self.sigmas:
            vv, uu = _grids(s)
            v, u, w = np.meshgrid(vv, uu, uu, indexing="ij")
            g = np.exp(-(u ** 2 + w ** 2) / (2.0 * s * s)).reshape(-1)
            self.tpl.append((np.stack([v.reshape(-1), u.reshape(-1), w.reshape(-1)], 1), g - g.mean()))

    def samples_per_query(self) -> int:
        return sum(len(o) for o, _ in self.tpl)

    def __call__(self, vol: torch.Tensor, pos: torch.Tensor, d: torch.Tensor):
        dev = vol.device
        corr, sig = [], []
        tpl = [(torch.from_numpy(o).to(dev), torch.from_numpy(g).to(dev, self.dtype))
               for o, g in self.tpl]
        for b in range(0, len(pos), self.chunk):
            p, dd = pos[b:b + self.chunk].float(), d[b:b + self.chunk].float()
            u, w = frame(dd)
            best = torch.full((len(p),), -float("inf"), device=dev)
            bsig = torch.zeros(len(p), device=dev)
            for s, (o, dw) in zip(self.sigmas, tpl):
                pts = (p[:, None] - o[None, :, 0:1] * dd[:, None] + o[None, :, 1:2] * u[:, None]
                       + o[None, :, 2:3] * w[:, None])
                vals = sample(vol, pts, self.dtype)
                dv = vals - vals.mean(dim=1, keepdim=True)
                a = (dv * dw).sum(1)
                den = (dv * dv).sum(1) * (dw * dw).sum()
                c = torch.where(den > _TINY, a / torch.sqrt(den.clamp(min=_TINY)),
                                torch.zeros_like(den)).float()
                take = c > best
                best = torch.where(take, c, best)
                bsig = torch.where(take, torch.full_like(bsig, s), bsig)
            corr.append(best)
            sig.append(bsig)
        if not corr:
            z = torch.zeros(0, device=dev)
            return z, z
        return torch.cat(corr), torch.cat(sig)


class Tube:
    """The tube approximation over per-sigma maps of the stack."""

    def __init__(self, sigmas, dtype=torch.float32, chunk: int = 4096):
        self.sigmas = [float(s) for s in sigmas]
        self.dtype, self.chunk = dtype, chunk
        self.consts = []
        for s in self.sigmas:
            vv, uu = _grids(s)
            u, w = np.meshgrid(uu, uu, indexing="ij")
            g = np.exp(-(u ** 2 + w ** 2) / (2.0 * s * s)).reshape(-1)
            half = int(math.ceil(3.0 * s))
            t = np.arange(-half, half + 1, dtype=np.float64)
            k1 = np.exp(-(t * t) / (2.0 * s * s))
            bh = int(round(3.0 * s))
            self.consts.append(dict(
                v=vv, gauss=k1, box=np.ones(2 * bh + 1),
                a1=float(g.sum()) / float(k1.sum()) ** 3,
                a2=g.size / float((2 * bh + 1) ** 3),
                gbar=float(g.sum()) / g.size, n=float(len(vv) * g.size),
                c=float(len(vv) * np.sum((g - g.sum() / g.size) ** 2))))
        self.maps: List[Tuple[torch.Tensor, ...]] = []

    def samples_per_query(self) -> int:
        return sum(len(k["v"]) for k in self.consts)

    def build(self, vol_u8: torch.Tensor):
        f = vol_u8.to(self.dtype)
        f2 = f * f

        def sep(a, taps):
            return correlate1d(correlate1d(correlate1d(a, taps, 2), taps, 1), taps, 0)

        self.maps = [(sep(f, k["gauss"]), sep(f, k["box"]), sep(f2, k["box"])) for k in self.consts]

    def __call__(self, pos: torch.Tensor, d: torch.Tensor):
        dev = pos.device
        corr, sig = [], []
        for b in range(0, len(pos), self.chunk):
            p, dd = pos[b:b + self.chunk].float(), d[b:b + self.chunk].float()
            best = torch.full((len(p),), -float("inf"), device=dev)
            bsig = torch.zeros(len(p), device=dev)
            for s, k, maps in zip(self.sigmas, self.consts, self.maps):
                v = torch.from_numpy(k["v"]).to(dev)
                pts = p[:, None] + v[None, :, None] * dd[:, None]
                s1, s2, s3 = (sample(m, pts, self.dtype).sum(1) for m in maps)
                s1, s2, s3 = s1 * k["a1"], s2 * k["a2"], s3 * k["a2"]
                a = s1 - k["gbar"] * s2
                den = (s3 - s2 * s2 / k["n"]).clamp(min=0.0) * k["c"]
                c = torch.where(den > _TINY, a / torch.sqrt(den.clamp(min=_TINY)),
                                torch.zeros_like(den)).float()
                take = c > best
                best = torch.where(take, c, best)
                bsig = torch.where(take, torch.full_like(bsig, s), bsig)
            corr.append(best)
            sig.append(bsig)
        if not corr:
            z = torch.zeros(0, device=dev)
            return z, z
        return torch.cat(corr), torch.cat(sig)
