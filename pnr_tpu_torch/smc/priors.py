"""SMC transition-prior tables.

Parity target: the Tracker constructor (pnr-vaa3d/tracker.cpp:376-476):

* Offset cloud: every nonzero integer offset (dx, dy, dz) with
  dx^2+dy^2+dz^2 <= (2*step)^2; the applied offset scales dz by 1/zdist
  (p), while the radial prior distance d0 uses the unscaled norm.
* Isotropic prior w0[s] = exp(-d^2 / (2 (step/3)^2)) over the scaled
  norm d, normalized, with cumulative sums for systematic sampling.
* Directional priors w[vi][s] = vonMises(kappa; v[vi] . u[s]) *
  exp(-(d0-step)^2 / (2 (step/3)^2)), one row per codebook direction,
  normalized per row, with cumulative sums. The von Mises normalizer
  uses the Bessel I0 (np.i0 is the same Abramowitz–Stegun polynomial
  as the reference's bessi0, tracker.cpp:2254-2270).

All tables are built once on host (numpy) and closed over as device
constants by the tracker.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pnr_tpu_torch.smc.directions import generate_directions


@dataclasses.dataclass(frozen=True)
class PriorTables:
    p: np.ndarray  # (S, 3) applied offsets (dx, dy, dz/zdist), float32
    u: np.ndarray  # (S, 3) unit directions of p
    w0: np.ndarray  # (S,) isotropic prior, normalized
    w0_cws: np.ndarray  # (S,) cumulative sum of w0
    v: np.ndarray  # (D, 3) direction codebook
    w: np.ndarray  # (D, S) directional priors, row-normalized
    w_cws: np.ndarray  # (D, S) per-row cumulative sums


def build_prior_tables(step: int, kappa: float, zdist: float, is2d: bool) -> PriorTables:
    rg = 2 * int(step)
    offs = []
    for dx in range(-rg, rg + 1):
        for dy in range(-rg, rg + 1):
            if is2d:
                r2 = dx * dx + dy * dy
                if 0 < r2 <= rg * rg:
                    offs.append((dx, dy, 0))
            else:
                for dz in range(-rg, rg + 1):
                    r2 = dx * dx + dy * dy + dz * dz
                    if 0 < r2 <= rg * rg:
                        offs.append((dx, dy, dz))
    offs = np.asarray(offs, np.float64)  # (S, 3) unscaled integer offsets

    p = offs.copy()
    p[:, 2] = p[:, 2] / zdist
    d = np.linalg.norm(p, axis=1)
    d0 = np.linalg.norm(offs, axis=1)
    u = p / d[:, None]

    sig = step / 3.0
    w0 = np.exp(-(d**2) / (2.0 * sig * sig))
    w0 = w0 / w0.sum()
    w0_cws = np.cumsum(w0)

    v = generate_directions(is2d).astype(np.float64)

    rad = np.exp(-((d0 - step) ** 2) / (2.0 * sig * sig))  # (S,)
    dotp = np.clip(v @ u.T, -1.0, 1.0)  # (D, S)
    circ = np.exp(kappa * dotp) / (2.0 * 3.14 * np.i0(kappa))
    w = circ * rad[None, :]
    w = w / w.sum(axis=1, keepdims=True)
    w_cws = np.cumsum(w, axis=1)

    return PriorTables(
        p=p.astype(np.float32),
        u=u.astype(np.float32),
        w0=w0.astype(np.float32),
        w0_cws=w0_cws.astype(np.float32),
        v=v.astype(np.float32),
        w=w.astype(np.float32),
        w_cws=w_cws.astype(np.float32),
    )
