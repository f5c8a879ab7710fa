"""Inputs and parity bars shared by the port's tests (tests/test_torch_*.py).

jax-free, so that the tests that need a card (test_torch_kernels.py) run
on a machine without jax: the same volumes and bars hold the CUDA kernels
to their plain PyTorch versions there, and the plain versions to the JAX
package here.
"""

import numpy as np
import torch

from pnr_tpu_torch.ops.frangi import normalize_to_u8

ZDIST = 2.0


def tube(shape, noise=0):
    rng = np.random.default_rng(3)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] / 2) ** 2 + ((z - shape[0] / 2) * ZDIST) ** 2
    v = 200.0 * np.exp(-d2 / (2 * 9.0))
    if noise:
        v = v + rng.integers(0, noise, shape)
    return np.clip(v, 0, 255).astype(np.uint8)


def mixed_sigma_volume():
    rng = np.random.default_rng(1)
    shape = (24, 40, 72)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 20) ** 2 + ((z - 12) * ZDIST) ** 2
    return np.clip(
        200.0 * np.exp(-d2 / 18.0) * (0.7 + 0.3 * np.sin(x / 4.0))
        + rng.normal(0, 20, shape) + 40.0,
        0, 255,
    ).astype(np.uint8)


def hostpath_volume(shape=(16, 48, 64), seed=7):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] // 2) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    return np.clip(
        200.0 * np.exp(-d2 / (2 * 3.0**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
        + rng.normal(0, 5, x.shape),
        0, 255,
    ).astype(np.uint8)


FRANGI_CASES = {
    "clean": (lambda: tube((16, 48, 72)), (2.0, 3.0)),
    "noisy_ragged": (lambda: tube((20, 40, 100), noise=40), (2.0, 3.0)),
    "sigmas_2_6": (mixed_sigma_volume, (2.0, 6.0)),
    "hostpath": (hostpath_volume, (2.0, 3.0)),
}


def as_numpy(out):
    return tuple(a.cpu().numpy() for a in out)


def j8_of(j, jmin, jmax):
    return normalize_to_u8(
        torch.from_numpy(np.array(j, np.float32)), torch.tensor(float(jmin)), torch.tensor(float(jmax))
    ).numpy().astype(int)


def dirs_aligned(j0, jmax0, v0, v1):
    m = np.asarray(j0) > 0.2 * float(jmax0)

    def dec(a):
        return np.asarray(a).astype(np.float32) / 255.0 * 2.0 - 1.0

    dot = sum(dec(a)[m] * dec(b)[m] for a, b in zip(v0, v1))
    return np.median(np.abs(dot)), (np.abs(dot) > 0.9).mean()


def check_clean(ref, got):
    j0, jmin0, jmax0, *v0 = ref
    j1, jmin1, jmax1, *v1 = got
    scale = max(float(jmax0), 1e-12)
    assert np.abs(j0 - j1).max() / scale < 1e-4
    assert abs(float(jmin0) - float(jmin1)) / scale < 1e-4
    assert abs(float(jmax0) - float(jmax1)) / scale < 1e-4
    med, frac = dirs_aligned(j0, jmax0, v0, v1)
    assert med > 0.99 and frac == 1.0


def check_noisy(ref, got):
    j0, jmin0, jmax0, *v0 = ref
    j1, jmin1, jmax1, *v1 = got
    assert j1.shape == j0.shape
    j8a, j8b = j8_of(j0, jmin0, jmax0), j8_of(j1, jmin1, jmax1)
    assert np.abs(j8a - j8b).max() <= 8
    assert (j8a != j8b).mean() < 0.01
    med, frac = dirs_aligned(j0, jmax0, v0, v1)
    assert med > 0.99 and frac > 0.95


def check_mixed(ref, got):
    j0, jmin0, jmax0 = ref[:3]
    j1, jmin1, jmax1 = got[:3]
    scale = max(float(jmax0), 1e-12)
    strong = j0 > 0.1 * scale
    assert np.abs(j0[strong] - j1[strong]).max() / scale < 1e-4
    j8a, j8b = j8_of(j0, jmin0, jmax0), j8_of(j1, jmin1, jmax1)
    assert np.abs(j8a - j8b).max() <= 8
    assert (j8a != j8b).mean() < 0.01


def check_hostpath(ref, got):
    jd, jmin_d, jmax_d, vxd = ref[:4]
    jh, jmin_h, jmax_h, vxh = got[:4]
    strong = jd > 0.1 * jd.max()
    rel = np.abs(jh[strong] - jd[strong]) / np.maximum(jd[strong], 1e-6)
    assert rel.max() < 3e-3, rel.max()
    diff = np.abs(j8_of(jh, jmin_h, jmax_h) - j8_of(jd, jmin_d, jmax_d))
    assert (diff > 1).mean() < 1e-3
    assert (vxh[strong] == vxd[strong]).mean() > 0.97


FRANGI_CHECKS = {
    "clean": check_clean,
    "noisy_ragged": check_noisy,
    "sigmas_2_6": check_mixed,
    "hostpath": check_hostpath,
}


# exact ZNCC queries

STEP = 2
T, B = 8, 20


def random_volume():
    return np.random.default_rng(5).integers(0, 256, (20, 48, 48), dtype=np.uint8)


def zncc_tube_volume():
    shape = (24, 96, 112)
    rng = np.random.default_rng(6)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 48) ** 2 + ((z - 12) * 2.0) ** 2
    return np.clip(
        200.0 * np.exp(-d2 / 18.0) * (0.7 + 0.3 * np.sin(x / 4.0))
        + rng.normal(0, 5, shape),
        0, 255,
    ).astype(np.uint8)


def flat_volume():
    """h and w smaller than the patch: py == h and px == w."""
    return np.random.default_rng(8).integers(0, 256, (24, 20, 30), dtype=np.uint8)


ZNCC_VOLUMES = {"random": random_volume, "tube": zncc_tube_volume, "flat": flat_volume}


def queries(shape, seed=0, t=T):
    """t trace clouds of B particles; cloud centres cover the whole
    volume, so clouds sit on the borders too (the first two, for t >= 2,
    on opposite corners)."""
    rng = np.random.default_rng(seed)
    l, h, w = shape
    centre = np.stack(
        [rng.uniform(0, w - 1, t), rng.uniform(0, h - 1, t), rng.uniform(0, l - 1, t)], -1
    )
    centre[0] = (0.0, 0.0, 0.0)
    if t > 1:
        centre[1] = (w - 1.0, h - 1.0, l - 1.0)
    pos = centre[:, None, :] + rng.uniform(-4, 4, (t, B, 3))
    d = rng.normal(size=(t, B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos.astype(np.float32), d.astype(np.float32)


# tube mode

TUBE_T, TUBE_N = 6, 15


def noisy_tube(shape=(24, 64, 96), radius=2.5, seed=3):
    """tests/test_zncc.py's make_noisy_tube."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] / 2.0) ** 2 + ((z - shape[0] / 2.0) * ZDIST) ** 2
    vol = 200.0 * np.exp(-d2 / (2 * radius**2)) + rng.normal(0, 4, shape)
    return np.clip(vol, 0, 255).astype(np.uint8)


def tube_queries(shape, t=TUBE_T, n=TUBE_N, seed=0, edges=False):
    """t trace clouds of n particles within 4 voxels of centres spread
    over the volume (with `edges`, pinned to its corners and faces)."""
    rng = np.random.default_rng(seed)
    l, h, w = shape
    centre = np.stack(
        [rng.uniform(0, w - 1, t), rng.uniform(0, h - 1, t), rng.uniform(0, l - 1, t)], -1
    )
    if edges:
        for i in range(t):
            centre[i] = [(w - 1) * (i % 2), (h - 1) * ((i // 2) % 2), (l - 1) * ((i // 4) % 2)]
    pos = centre[:, None, :] + rng.uniform(-4, 4, (t, n, 3))
    d = rng.normal(size=(t, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos.astype(np.float32), d.astype(np.float32)


#: tube engine cases: (volume shape, sigmas, reuse, edges)
ENGINE_CASES = {
    "reuse1": ((24, 64, 96), (2.0, 3.0), 1, False),
    "reuse3": ((24, 64, 96), (2.0, 3.0), 3, False),
    "edges": ((24, 64, 96), (2.0, 3.0), 1, True),
    "sigmas_2_4_6": ((24, 64, 96), (2.0, 4.0, 6.0), 1, False),
    # h and w under the window: the windows are clipped to the volume
    "degenerate": ((20, 12, 14), (2.0, 3.0), 1, False),
}


# 2-D (one-plane) stacks


def plane_tube(shape=(1, 72, 96), radius=2.5, seed=4, angle=0.35):
    """A noisy bright line across a single plane, at `angle` to x."""
    rng = np.random.default_rng(seed)
    _, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    cy, cx = shape[1] / 2.0, shape[2] / 2.0
    d = (y - cy) * np.cos(angle) - (x - cx) * np.sin(angle)
    vol = 200.0 * np.exp(-d * d / (2 * radius**2)) * (0.75 + 0.25 * np.sin(x / 5.0))
    return np.clip(vol + rng.normal(0, 4, shape), 0, 255).astype(np.uint8)


def queries_2d(shape, t=T, n=B, seed=0, edges=False):
    """`queries` in the plane: t clouds of n particles within 4 pixels of
    centres spread over the plane (the first two on opposite corners; with
    `edges`, every centre on a corner or an edge), z = 0, directions in
    the xy plane."""
    rng = np.random.default_rng(seed)
    _, h, w = shape
    centre = np.stack([rng.uniform(0, w - 1, t), rng.uniform(0, h - 1, t)], -1)
    centre[0] = (0.0, 0.0)
    if t > 1:
        centre[1] = (w - 1.0, h - 1.0)
    if edges:
        for i in range(t):
            centre[i] = [(w - 1) * (i % 2), (h - 1) * ((i // 2) % 2)] if i % 3 else \
                [(w - 1) * (i % 2), centre[i, 1]]
    xy = centre[:, None, :] + rng.uniform(-4, 4, (t, n, 2))
    pos = np.concatenate([xy, np.zeros((t, n, 1))], -1)
    a = rng.uniform(0, 2 * np.pi, (t, n))
    d = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)], -1)
    return pos.astype(np.float32), d.astype(np.float32)
