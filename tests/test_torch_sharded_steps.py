"""The sharded layer's library steps (`seeds_sharded`,
`build_local_trace_step`, `build_sharded_step`, `build_seed_scorer`)
against the JAX package's on its 8-device CPU mesh set-up and against the
port's own single-device modules, on four-shard CPU meshes.

Bars: `seeds_sharded` pos, valid and found bitwise JAX's, dirs within
1e-6; the local and full steps' traces against JAX's at
tests/test_torch_tracker.py's bar (every estimate column within 1e-3,
sigma and valid exact) where both trace inside their slabs (exact mode,
on the same volume; tube mode builds its maps in each package and is
held to the port's single-device trace instead); a trace that stays in
its slab bitwise the port's single-device trace, and a handed-off trace
of the full step bitwise `trace_wave` with the same ids and key.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pnr_tpu.config import PNRConfig as JaxConfig
from pnr_tpu.parallel import make_mesh as jax_make_mesh
from pnr_tpu.parallel import shard_volume as jax_shard_volume
from pnr_tpu.parallel.sharded import build_local_trace_step as jax_local_step
from pnr_tpu.parallel.sharded import build_sharded_step as jax_sharded_step
from pnr_tpu.parallel.sharded import seeds_sharded as jax_seeds_sharded
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.ops.frangi import frangi3d, normalize_to_u8
from pnr_tpu_torch.parallel import (
    assign_seeds_to_shards,
    build_local_trace_step,
    build_sharded_step,
    frangi3d_sharded,
    make_mesh,
    normalize_to_u8_sharded,
    seeds_sharded,
    shard_volume,
    stitch_estimates,
)
from pnr_tpu_torch.pipeline.sharded_reconstruct import build_seed_scorer
from pnr_tpu_torch.seeds.extract import max_points_device
from pnr_tpu_torch.smc.tracker import BatchedTracker, trace_keys

N = 4
SHAPE = (32, 24, 48)
CFG = dict(sigmas=(2.0,), znccth=0.3, kappa=2.0, step=2, ni=8, np=8, zdist=2.0, nodepervol=4,
           vol=9, tolerance=10.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (tests/test_torch_sharded.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(N)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N, device="cpu")


def two_tubes(shape=SHAPE, seed=0):
    """Two x-aligned tubes inside shards 1 and 2, modulated along x (a
    constant ridge floods to the border and yields no seed)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    v = np.zeros(shape)
    for yc, zc in ((8, 11), (16, 21)):
        d2 = (y - yc) ** 2 + ((z - zc) * 2.0) ** 2
        v = np.maximum(v, 190.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.75 + 0.25 * np.sin(x / 4.0)))
    return np.clip(v + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


SEEDS = np.array([[10.0, 8.0, 11.0], [30.0, 8.0, 11.0], [12.0, 16.0, 21.0], [34.0, 16.0, 21.0]],
                 np.float32)
DIRS = np.array([[1.0, 0, 0], [-1.0, 0, 0], [1.0, 0, 0], [-1.0, 0, 0]], np.float32)


def single_device(cfg, vol, sp, sd, key, ids):
    """The port's single-device trace of each seed: (T, ni, 9)."""
    tracker = BatchedTracker(dataclasses.replace(cfg, patch_reuse=1), "cpu")
    field = tracker.prepare_field(torch.from_numpy(vol))
    keys = trace_keys(key, ids)
    carry, e0 = tracker.trace_init(field, sp, sd, keys)
    _, pk = tracker.trace_stage(field, keys, carry, 1, cfg.ni - 1,
                                torch.zeros(len(sp), dtype=torch.bool))
    return torch.cat([e0[:, None], pk], dim=1).numpy()


def assert_tracks_jax(got, want):
    """tests/test_torch_tracker.py's bar."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    for col in (6, 8):
        assert np.array_equal(got[..., col], want[..., col])


# -- seeds ----------------------------------------------------------------------


@pytest.mark.parametrize("cap", [3, 64])
def test_seeds_sharded_bitwise_jax(jmesh, mesh, cap):
    """On the same J8 and direction maps: pos, valid and found bitwise JAX's,
    dirs within 1e-6, where cap 3 keeps the strongest of many (ties in
    voxel order); cap 64 is more than a shard finds, so every seed of the
    device flood comes back."""
    vol = two_tubes()
    j, jmin, jmax, vx, vy, vz = frangi3d(torch.from_numpy(vol), (2.0,), 2.0)
    maps = [a.numpy() for a in (normalize_to_u8(j, jmin, jmax), vx, vy, vz)]
    got = seeds_sharded(*[shard_volume(a, mesh) for a in maps], 10.0, mesh, cap)
    assert got[0].shape == (N * cap, 3) and got[3].shape == (N,)
    mask = max_points_device(torch.from_numpy(maps[0]), 10.0).numpy()
    assert got[3].sum() == mask.sum() and got[2].any()
    if cap == 64:  # more than any shard finds: every seed of the flood, then pad rows
        assert got[2].sum() == mask.sum()
        assert {tuple(p) for p in got[0][got[2]].astype(int).tolist()} == {
            (x, y, z) for z, y, x in zip(*np.nonzero(mask))}
        return
    assert (got[3] > cap).any()
    want = [np.asarray(a) for a in jax.jit(
        lambda *a: jax_seeds_sharded(*a, 10.0, jmesh, cap))(*[jax_shard_volume(a, jmesh) for a in maps])]
    for i in (0, 2, 3):
        assert np.array_equal(got[i], want[i]), i
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)


# -- shard-local tracing -----------------------------------------------------------


def test_local_trace_step_tracks_jax_and_single_device(jmesh, mesh):
    vol = two_tubes()
    k = 2
    sp, sd, valid = assign_seeds_to_shards(SEEDS, DIRS, SHAPE[0], N, k)
    cfg = PNRConfig(**CFG, zncc_mode="exact")
    got = build_local_trace_step(cfg, mesh, k)(shard_volume(vol, mesh), sp, sd, tf.key_from_seed(0))
    want = np.asarray(jax_local_step(JaxConfig(**CFG, zncc_mode="exact"), jmesh, k)(
        jax_shard_volume(vol, jmesh), sp, sd, jax.random.key(0)))
    assert got.shape == (N * k, cfg.ni, 9)
    assert got[valid, :4, 8].all()
    assert_tracks_jax(got[valid], want[valid])
    ref = single_device(cfg, vol, sp, sd, tf.key_from_seed(0), np.arange(N * k))
    assert np.array_equal(got[valid], ref[valid])


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_local_trace_ends_at_its_slab(mesh, mode):
    """A trace seeded in shard 1 heading +z along a z-tube leaves its slab
    (the default halo, 17 planes: shard 1 holds planes [24, 48) and its
    slab [7, 65)). It is bitwise the single-device trace while its windows
    lie in the slab (the first iterations), and it ends at the first
    estimate whose centroid rounds past the slab, where the single-device
    trace goes on."""
    shape = (96, 24, 40)
    rng = np.random.default_rng(9)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 12) ** 2 + (x - 20) ** 2
    vol = np.clip(200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.75 + 0.25 * np.sin(z / 3.0))
                  + rng.normal(0, 4, shape), 0, 255).astype(np.uint8)
    cfg = PNRConfig(**dict(CFG, zdist=1.0, ni=16, kappa=4.0, znccth=0.2, np=16), zncc_mode=mode)
    sp, sd, valid = assign_seeds_to_shards(np.array([[20.0, 12.0, 46.0]], np.float32),
                                           np.array([[0.0, 0.0, 1.0]], np.float32), shape[0], N, 1)
    got = build_local_trace_step(cfg, mesh, 1)(shard_volume(vol, mesh), sp, sd, tf.key_from_seed(0))[1]
    ref = single_device(cfg, vol, sp, sd, tf.key_from_seed(0), np.arange(N))[1]
    assert np.array_equal(got[:3], ref[:3])
    ok = got[:, 8] > 0.5
    end = int(ok.sum())
    assert 3 <= end < cfg.ni and ok[:end].all() and ref[:end + 1, 8].all()
    zr = np.floor(got[:, 2] + 0.5)
    assert (zr[:end] < 65).all() and zr[end] >= 65


# -- the full step -------------------------------------------------------------------


def _full_step(cfg, mesh, vol, wave=8):
    return build_sharded_step(cfg, mesh, wave=wave)(shard_volume(vol, mesh), tf.key_from_seed(3))


def test_sharded_step_tracks_jax(jmesh, mesh):
    vol = two_tubes()
    cfg = PNRConfig(**CFG, zncc_mode="exact")
    got = _full_step(cfg, mesh, vol)
    want = {k: np.asarray(v) for k, v in jax_sharded_step(JaxConfig(**CFG, zncc_mode="exact"), jmesh,
                                                            wave=8)(
        jax_shard_volume(vol, jmesh), jax.random.key(3)).items()}
    j8 = torch.cat(got["j8"]).numpy()
    assert np.array_equal(j8, want["j8"])
    for name in ("seed_pos", "seed_valid", "seeds_found", "est_ids", "handoff_lost"):
        assert np.array_equal(got[name], want[name]), name
    assert got["est_packs"].shape == want["est_packs"].shape == (3, N * 6, 4, 9)
    est, ids = stitch_estimates(got["est_packs"], got["est_ids"], cfg.ni)
    est_j, ids_j = stitch_estimates(want["est_packs"], want["est_ids"], cfg.ni)
    assert np.array_equal(ids, ids_j) and len(ids) >= 4
    ok = est[:, :, 8] > 0.5
    assert ok.sum() > 10
    assert np.array_equal(ok, est_j[:, :, 8] > 0.5)
    assert_tracks_jax(np.where(ok[..., None], est, 0), np.where(ok[..., None], est_j, 0))


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_sharded_step_bitwise_single_device(mesh, mode):
    """J8 bitwise the monolithic filter's; each shard's seeds the strongest
    of the flood of its slab; the stitched traces bitwise `trace_wave` on
    the whole volume with the same ids and key."""
    vol = two_tubes()
    cfg = PNRConfig(**CFG, zncc_mode=mode)
    out = _full_step(cfg, mesh, vol, wave=6)
    j, jmin, jmax, _, _, _ = frangi3d(torch.from_numpy(vol), cfg.sigmas, cfg.zdist)
    j8 = normalize_to_u8(j, jmin, jmax)
    assert torch.equal(torch.cat(out["j8"]), j8)
    per = 2  # ceil(6 / 4)
    mask = max_points_device(j8, cfg.tolerance).numpy()
    for s in range(N):
        zz, yy, xx = np.nonzero(mask[s * 8:(s + 1) * 8])
        score = j8.numpy()[s * 8:(s + 1) * 8][zz, yy, xx]
        order = np.lexsort((np.arange(len(score)), -score.astype(int)))[:per]
        want = np.stack([xx[order], yy[order], zz[order] + s * 8], -1).astype(np.float32)
        got = out["seed_pos"][s * per:s * per + len(order)]
        assert np.array_equal(got, want), s
    est, ids = stitch_estimates(out["est_packs"], out["est_ids"], cfg.ni)
    lanes = 2 * per + 2
    dirs = _seed_dirs(cfg, vol, mesh, per)
    rows = [divmod(int(t), lanes) for t in ids]
    sp = np.stack([out["seed_pos"][s * per + i] for s, i in rows])
    sd = np.stack([dirs[s * per + i] for s, i in rows])
    tracker = BatchedTracker(cfg, "cpu")
    field = tracker.prepare_field(torch.from_numpy(vol))
    ref = tracker.trace_wave(field, sp, sd, tf.key_from_seed(3), ids)
    ok = est[:, :, 8] > 0.5
    assert ok.sum() > 10
    assert np.array_equal(ok, ref.valid)
    assert np.array_equal(est[ok][:, :3], ref.pos[ok])
    assert np.array_equal(est[ok][:, 6], ref.sig[ok]) and np.array_equal(est[ok][:, 7], ref.corr[ok])


def _seed_dirs(cfg, vol, mesh, per):
    """The decoded seed directions of the step's seeds."""
    j, jmin, jmax, vx, vy, vz = frangi3d_sharded(shard_volume(vol, mesh), cfg.sigmas, cfg.zdist, mesh)
    return seeds_sharded(normalize_to_u8_sharded(j, jmin, jmax), vx, vy, vz, cfg.tolerance, mesh,
                         per)[1]


# -- the seed scorer -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_seed_scorer_bitwise_single_device(mesh, mode):
    vol = two_tubes()
    cfg = PNRConfig(**CFG, zncc_mode=mode)
    got = build_seed_scorer(cfg, mesh)(shard_volume(vol, mesh), SEEDS, DIRS)
    tracker = BatchedTracker(cfg, "cpu")
    field = tracker.prepare_field(torch.from_numpy(vol))
    want, _ = tracker.engine.eval_fused(field, torch.from_numpy(SEEDS)[:, None],
                                        torch.from_numpy(DIRS)[:, None])
    assert got.shape == (len(SEEDS),) and (got > 0.3).all()
    assert np.array_equal(got, want[:, 0].numpy())
