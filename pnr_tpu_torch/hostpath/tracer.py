"""Host SMC tracer: vectorized NumPy mirror of the device wave tracer.

A copy of pnr_tpu/hostpath/tracer.py, imports aside.

Same math, same PRNG streams, same estimate/stop semantics as
`pnr_tpu.smc.tracker.BatchedTracker._build_trace_wave` (parity target
`Tracker::trackPos`/`iter0New`/`iterINew`, pnr-vaa3d/tracker.cpp:
825-933, 1001-1198). The whole wave advances in lockstep over (T, P)
arrays — NumPy per-op overhead amortizes over the wave exactly as the
device amortizes it over lanes (a per-trace scalar loop measured 11.7 s
on the 1.18-Mvox one-shot stack; this wave form runs the same seeds in
~0.5 s). Killed lanes are COMPACTED away by the caller between stages
(the host analog of the device kill mask) so stopped traces cost no
further compute — the reference's own stop-early economy.

PRNG streams are the bit-exact threefry port (hostpath/threefry.py),
keyed per (trace id, absolute iteration) exactly like the device, so
staging/compaction never changes results.
"""

from __future__ import annotations

import numpy as np

from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.smc.priors import build_prior_tables


def _round_half_away(x):
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


class HostWaveTracer:
    """Lockstep SMC wave tracer over a host likelihood field.

    zncc_fn(pos (N, 3), dirs (N, 3)) -> (corr (N,), sig (N,)) evaluates
    the likelihood (tube maps or exact znccBBB — hostpath/pipeline.py).
    """

    def __init__(self, cfg, is2d: bool, zncc_fn, vol_shape):
        self.cfg = cfg
        self.is2d = is2d
        self.zncc = zncc_fn
        self.vol_shape = vol_shape  # (l, h, w)
        t = build_prior_tables(cfg.step, cfg.kappa, cfg.zdist, is2d)
        self.p_tab = np.asarray(t.p, np.float32)
        self.u_tab = np.asarray(t.u, np.float32)
        self.w0_tab = np.asarray(t.w0, np.float32)
        self.w0_cws = np.asarray(t.w0_cws, np.float32)
        self.v_tab = np.asarray(t.v, np.float32)
        self.w_tab = np.asarray(t.w, np.float32)
        self.w_cws = np.asarray(t.w_cws, np.float32)
        self.sz = self.p_tab.shape[0]
        self.w_flat = self.w_tab.reshape(-1).astype(np.float32)

    # -- helpers mirroring smc/tracker.py ------------------------------
    def _in_bounds(self, cpos):
        l, h, w = self.vol_shape
        x1 = _round_half_away(cpos[:, 0])
        y1 = _round_half_away(cpos[:, 1])
        z1 = _round_half_away(cpos[:, 2])
        return (
            (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h) & (z1 >= 0) & (z1 < l)
        )

    def _flat_zncc(self, pos, dirs):
        t, p, _ = pos.shape
        corr, sig = self.zncc(pos.reshape(t * p, 3), dirs.reshape(t * p, 3))
        return corr.reshape(t, p), sig.reshape(t, p)

    def _estimate(self, pos, dirs, wgt):
        cpos = np.sum(wgt[..., None] * pos, axis=1, dtype=np.float32)
        cdir = np.sum(wgt[..., None] * dirs, axis=1, dtype=np.float32)
        cdir = cdir / np.linalg.norm(cdir, axis=-1, keepdims=True).astype(np.float32)
        ccorr, csig = self.zncc(cpos, cdir)
        return cpos, cdir, ccorr, csig

    def _systematic(self, wgt, res_u, npart):
        csw = np.cumsum(wgt, axis=1, dtype=np.float32)
        ui = ((np.arange(npart, dtype=np.float32)[None, :] + res_u[:, None])
              / np.float32(npart))
        ridx = np.sum(csw[:, None, :] < ui[..., None], axis=-1)
        return np.clip(ridx, 0, npart - 1)

    # -- wave API ------------------------------------------------------
    def trace_init(self, seed_pos, seed_dir, keys):
        """Iteration 0 (iter0New). Returns (carry, est0 (T, 9))."""
        cfg = self.cfg
        npart = cfg.np
        fp32 = np.float32
        t = seed_pos.shape[0]

        u0 = tf.uniforms_per_trace(keys, 0, 1)[:, 0]  # (T,)
        ui = ((np.arange(npart, dtype=fp32)[None, :] + u0[:, None])
              / fp32(npart))
        s = np.sum(self.w0_cws[None, None, :] < ui[..., None], axis=-1)
        s = np.clip(s, 0, self.sz - 1)  # (T, P)
        pos = seed_pos[:, None, :] + self.p_tab[s]
        have_dir = ~np.any(np.isnan(seed_dir), axis=-1)  # (T,)
        dirs = np.where(
            have_dir[:, None, None],
            np.broadcast_to(seed_dir[:, None, :], (t, npart, 3)),
            self.u_tab[s],
        ).astype(fp32)
        prior = self.w0_tab[s]

        corr, _ = self._flat_zncc(pos, dirs)
        lhood = np.exp(cfg.kc * corr, dtype=fp32)
        wgt = (fp32(1.0 / npart)
               * (prior / prior.sum(axis=1, keepdims=True, dtype=fp32))
               * lhood)
        wgt = (wgt / wgt.sum(axis=1, keepdims=True, dtype=fp32)).astype(fp32)
        neff = fp32(1.0) / np.sum(wgt * wgt, axis=1, dtype=fp32)

        cpos, cdir, ccorr, csig = self._estimate(pos, dirs, wgt)
        ok0 = self._in_bounds(cpos) & (ccorr >= cfg.znccth)

        resampled = neff / npart < cfg.neff_ratio
        res_u = tf.uniforms_per_trace(keys, 1, 1)[:, 0]
        res_idx = self._systematic(wgt, res_u, npart)

        est0 = np.concatenate(
            [cpos, cdir, csig[:, None], ccorr[:, None],
             ok0[:, None].astype(fp32)], axis=1,
        )
        carry = (pos, dirs, wgt, resampled, res_idx, ok0.copy())
        return carry, est0

    def trace_stage(self, keys, carry, iter_idx):
        """Iterations iter_idx (absolute). Returns (carry, packed
        (T, n_it, 9)). Caller compacts killed lanes away beforehand."""
        cfg = self.cfg
        npart = cfg.np
        fp32 = np.float32
        pos, dirs, wgt, resampled, res_idx, alive = carry
        t = pos.shape[0]
        arange_p = np.arange(npart)
        ests = []

        for i in iter_idx:
            u1 = tf.uniforms_per_trace(keys, 2 * int(i), npart)  # (T, P)
            res_u = tf.uniforms_per_trace(keys, 2 * int(i) + 1, 1)[:, 0]

            k1 = np.where(resampled[:, None], res_idx, arange_p[None, :])
            ti = np.arange(t)[:, None]
            base_pos = pos[ti, k1]
            base_dir = dirs[ti, k1]

            dots = base_dir.reshape(t * npart, 3) @ self.v_tab.T
            vi = np.argmax(dots, axis=1)  # (TP,)
            rows = self.w_cws[vi]  # (TP, S)
            s = np.clip(
                np.sum(rows < u1.reshape(t * npart, 1), axis=-1), 0, self.sz - 1
            )
            pos = base_pos + self.p_tab[s].reshape(t, npart, 3)
            dirs = self.u_tab[s].reshape(t, npart, 3)
            prior = self.w_flat[vi * self.sz + s].reshape(t, npart)

            corr, _ = self._flat_zncc(pos, dirs)
            lhood = np.exp(cfg.kc * corr, dtype=fp32)
            prev_w = np.where(resampled[:, None], fp32(1.0 / npart), wgt)
            wgt = (prev_w
                   * (prior / prior.sum(axis=1, keepdims=True, dtype=fp32))
                   * lhood)
            wgt = (wgt / wgt.sum(axis=1, keepdims=True, dtype=fp32)).astype(fp32)
            neff = fp32(1.0) / np.sum(wgt * wgt, axis=1, dtype=fp32)

            cpos, cdir, ccorr, csig = self._estimate(pos, dirs, wgt)
            ok = self._in_bounds(cpos) & (ccorr >= cfg.znccth)
            alive = alive & ok

            resampled = neff / npart < cfg.neff_ratio
            res_idx = self._systematic(wgt, res_u, npart)
            ests.append(np.concatenate(
                [cpos, cdir, csig[:, None], ccorr[:, None],
                 alive[:, None].astype(fp32)], axis=1,
            ))

        carry = (pos, dirs, wgt, resampled, res_idx, alive)
        return carry, np.stack(ests, axis=1)  # (T, n_it, 9)


def compact_carry(carry, keep):
    """Select lanes `keep` (bool or index array) from a carry."""
    pos, dirs, wgt, resampled, res_idx, alive = carry
    return (pos[keep], dirs[keep], wgt[keep], resampled[keep],
            res_idx[keep], alive[keep])
