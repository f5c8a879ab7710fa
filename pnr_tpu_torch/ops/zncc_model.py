"""Host-precomputed ZNCC model tables — jax-free.

`ZnccTemplates` (the exact znccBBB template lattice, Tracker ctor
pnr-vaa3d/tracker.cpp:178-232) and `TubeZnccModel` (the tube-map
constants, see ops/zncc_fast.py) live here so the host one-shot engine
(pnr_tpu.hostpath) can build identical models without importing jax;
ops/zncc.py and ops/zncc_fast.py re-export them unchanged.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def _frac_range(half: int, pitch: float) -> np.ndarray:
    """Values -half, -half+pitch, ... while <= half (+FLT_MIN), as the reference loop."""
    n = int(math.floor((2.0 * half) / pitch + 1e-6)) + 1
    return (-half + np.arange(n) * pitch).astype(np.float32)


class ZnccTemplates:
    """Precomputed per-sigma template offsets/weights (Tracker ctor :178-232)."""

    def __init__(self, sigmas: Sequence[float], is2d: bool, samples_per_3sig: int = 12):
        self.sigmas = tuple(float(s) for s in sigmas)
        self.is2d = bool(is2d)
        offs_list = []
        wgt_list = []
        for sig in self.sigmas:
            v2 = int(round(1.0 * sig))
            u2 = int(round(3.0 * sig))
            pitch = max(1.0, (3.0 * sig) / samples_per_3sig)
            vv = _frac_range(v2, pitch)
            uu = _frac_range(u2, pitch)
            if self.is2d:
                v_g, u_g = np.meshgrid(vv, uu, indexing="ij")
                w_g = np.zeros_like(v_g)
                wgt = np.exp(-(u_g**2) / (2.0 * sig * sig))
            else:
                v_g, u_g, w_g = np.meshgrid(vv, uu, uu, indexing="ij")
                wgt = np.exp(-(u_g**2 + w_g**2) / (2.0 * sig * sig))
            offs = np.stack(
                [v_g.reshape(-1), u_g.reshape(-1), w_g.reshape(-1)], axis=-1
            ).astype(np.float32)
            offs_list.append(offs)
            wgt_list.append(wgt.reshape(-1).astype(np.float32))

        kmax = max(o.shape[0] for o in offs_list)
        s = len(self.sigmas)
        self.offs = np.zeros((s, kmax, 3), np.float32)
        self.wgt = np.zeros((s, kmax), np.float32)
        self.mask = np.zeros((s, kmax), np.float32)
        self.cnt = np.zeros((s,), np.float32)
        self.avg = np.zeros((s,), np.float32)
        self.corrc = np.zeros((s,), np.float32)
        for i, (o, g) in enumerate(zip(offs_list, wgt_list)):
            k = o.shape[0]
            self.offs[i, :k] = o
            self.wgt[i, :k] = g
            self.mask[i, :k] = 1.0
            self.cnt[i] = k
            self.avg[i] = g.sum() / k
            self.corrc[i] = np.sum((g - self.avg[i]) ** 2)
        self.kmax = kmax


class TubeZnccModel:
    """Per-sigma constants for the tube ZNCC (host-precomputed)."""

    def __init__(self, sigmas: Sequence[float], is2d: bool, samples_per_3sig: int = 12):
        self.sigmas = tuple(float(s) for s in sigmas)
        self.is2d = bool(is2d)
        s = len(self.sigmas)

        self.v_grids = []  # per sigma: v-axis sample offsets
        self.alpha1 = np.zeros(s, np.float32)
        self.alpha2 = np.zeros(s, np.float32)
        self.gbar = np.zeros(s, np.float32)
        self.n = np.zeros(s, np.float32)
        self.corrc = np.zeros(s, np.float32)
        self.gauss_kernels = []  # unnormalized exp(-t^2/2s^2) 1-D kernels
        self.box_half = []

        for i, sig in enumerate(self.sigmas):
            v2 = int(round(1.0 * sig))
            u2 = int(round(3.0 * sig))
            pitch = max(1.0, (3.0 * sig) / samples_per_3sig)
            vv = _frac_range(v2, pitch)
            uu = _frac_range(u2, pitch)
            self.v_grids.append(vv)

            if self.is2d:
                u_g = uu
                g = np.exp(-(u_g**2) / (2.0 * sig * sig))
            else:
                u_g, w_g = np.meshgrid(uu, uu, indexing="ij")
                g = np.exp(-(u_g**2 + w_g**2) / (2.0 * sig * sig)).reshape(-1)
            n_uw = g.size
            n_total = len(vv) * n_uw
            gsum = float(g.sum())
            gbar = gsum / n_uw  # template mean per v-plane == overall mean
            self.n[i] = n_total
            self.gbar[i] = gbar
            # template auto-correlation sum_k (g_k - gbar)^2 over ALL samples
            self.corrc[i] = float(len(vv) * np.sum((g - gbar) ** 2))

            half = int(math.ceil(3.0 * sig))
            t = np.arange(-half, half + 1, dtype=np.float64)
            k1 = np.exp(-(t * t) / (2.0 * sig * sig))
            self.gauss_kernels.append(k1.astype(np.float32))
            s1d = float(k1.sum())
            dims = 2 if self.is2d else 3
            # match I==1: sum_v M1 = n_v * s1d^dims  ->  a1 * that == n_v * gsum
            self.alpha1[i] = gsum / (s1d**dims)

            bh = u2
            self.box_half.append(bh)
            box_total = float((2 * bh + 1) ** dims)
            self.alpha2[i] = n_uw / box_total
