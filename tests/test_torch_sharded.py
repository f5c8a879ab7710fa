"""The port's mesh, halo exchange, sharded filter and handoff tracer
(pnr_tpu_torch/parallel) against the JAX package and the port's own
single-device modules, on the CPU.

The JAX side runs on the conftest's 8-device CPU mesh through
`pnr_tpu.parallel.make_mesh(4)`; the port on a 4-shard CPU mesh
(`make_mesh(4, device="cpu")`). Inputs are made from a seed with numpy.
Bars: the halos bitwise JAX's; the sharded filters bitwise the port's
monolithic filters (every route: monolithic, tiled, Z-blocked) and within
tests/_torch_cases.py's bars of JAX's sharded filter; a trace that
crosses shards bitwise the port's single-device trace.
"""

import numpy as np
import pytest
import torch

import jax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from _torch_cases import FRANGI_CASES, FRANGI_CHECKS, ZDIST
from pnr_tpu.parallel import frangi3d_sharded as jax_frangi3d_sharded
from pnr_tpu.parallel import halo_exchange_z as jax_halo_exchange_z
from pnr_tpu.parallel import make_mesh as jax_make_mesh
from pnr_tpu.parallel import shard_volume as jax_shard_volume
from pnr_tpu.parallel.halo import halo_exchange_z_aligned as jax_halo_aligned
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.ops.frangi import frangi2d, frangi3d
from pnr_tpu_torch.parallel import (
    Mesh,
    build_handoff_trace_step,
    frangi2d_sharded,
    frangi3d_sharded,
    halo_exchange_z,
    halo_exchange_z_aligned,
    make_mesh,
    normalize_to_u8_sharded,
    shard_volume,
    stitch_estimates,
)
from pnr_tpu_torch.pipeline import reconstruct
from pnr_tpu_torch.smc.tracker import BatchedTracker, trace_keys

N = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: beside other test workers and
    JAX's threads, torch's spinning OpenMP workers slowed this file's small
    ops by one to two orders of magnitude (a 40-s run took 324 s under two
    xdist workers)."""
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


def volume(shape, seed=0):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] // 2) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    v = 180.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.75 + 0.25 * np.sin(x / 4.0))
    return np.clip(v + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


def stack(parts):
    return np.concatenate([p.numpy() for p in parts])


# -- the mesh ---------------------------------------------------------------


def test_make_mesh_cpu_and_virtual():
    m = make_mesh(3, device="cpu")
    assert m.size == 3 and all(d.type == "cpu" for d in m.devices)
    v = Mesh((torch.device("cuda:0"),) * 4)
    assert v.size == 4 and len(set(v.devices)) == 1


def test_make_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)


def test_shard_volume_places_slabs(mesh):
    vol = volume((16, 8, 12))
    parts = shard_volume(vol, mesh)
    assert [tuple(p.shape) for p in parts] == [(4, 8, 12)] * N
    np.testing.assert_array_equal(stack(parts), vol)
    with pytest.raises(ValueError, match="must divide"):
        shard_volume(vol[:15], mesh)


# -- halos: bitwise JAX's ------------------------------------------------------


def _jax_blocks(jmesh, vol, fn):
    """A JAX halo function's per-shard outputs."""
    out = shard_map(fn, mesh=jmesh, in_specs=P("z"), out_specs=(P("z"), P("z")),
                    check_vma=False)(jax_shard_volume(vol, jmesh))
    slabs, offs = (np.asarray(a) for a in out)
    return np.split(slabs, N), offs.reshape(N)


@pytest.mark.parametrize("shape,halo", [
    ((32, 8, 16), 3),  # shallower than a shard
    ((32, 8, 16), 11),  # deeper than a shard: several hops
    ((16, 6, 10), 9),  # deeper than the volume
])
def test_halo_exchange_bitwise_jax(jmesh, mesh, shape, halo):
    vol = volume(shape)
    want, _ = _jax_blocks(jmesh, vol, lambda v: (jax_halo_exchange_z(v, halo, "z"),
                                                  jax.numpy.zeros(1, "int32")))
    got = halo_exchange_z(shard_volume(vol, mesh), halo)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("shape,halo", [
    ((32, 8, 16), 3),  # shallower than a shard
    ((32, 8, 16), 7),  # edge shards reach two shards away
    ((16, 8, 16), 9),  # the slab is deeper than the volume: the whole-volume gather
])
def test_halo_exchange_aligned_bitwise_jax(jmesh, mesh, shape, halo):
    vol = volume(shape)
    want, offs = _jax_blocks(jmesh, vol, lambda v: (lambda sl, o: (sl, o.reshape(1)))(
        *jax_halo_aligned(v, halo, "z")))
    got = halo_exchange_z_aligned(shard_volume(vol, mesh), halo)
    for w, o, (slab, off) in zip(want, offs, got):
        np.testing.assert_array_equal(slab.numpy(), w)
        assert off == int(o)


# -- the sharded filters --------------------------------------------------------


def _route(monkeypatch, route):
    """Force the sharded filter's route on small slabs."""
    if route != "monolithic":
        monkeypatch.setattr(reconstruct, "UNFUSED_MAX_VOXELS", 1)
        monkeypatch.setattr(reconstruct, "TILE_VOX_BUDGET", 6000)
        monkeypatch.setattr(reconstruct, "FRANGI2D_TILED_PIXELS", 1)
    if route == "blocked":
        import pnr_tpu_torch.parallel.sharded as sharded

        monkeypatch.setattr(sharded, "pick_blocks", lambda *a, **k: None)


@pytest.mark.parametrize("route", ["monolithic", "tiled", "blocked"])
@pytest.mark.parametrize("case", list(FRANGI_CASES))
def test_frangi3d_sharded_bitwise_monolithic(mesh, monkeypatch, case, route):
    make, sig = FRANGI_CASES[case]
    vol = make()
    want = frangi3d(torch.from_numpy(vol), sig, ZDIST)
    _route(monkeypatch, route)
    j, jmin, jmax, vx, vy, vz = frangi3d_sharded(shard_volume(vol, mesh), sig, ZDIST, mesh)
    for a, b in zip((j, vx, vy, vz), (want[0], want[3], want[4], want[5])):
        assert torch.equal(torch.cat(a), b)
    assert torch.equal(jmin, want[1]) and torch.equal(jmax, want[2])


def test_frangi3d_sharded_routes_by_the_lower_peak(mesh, monkeypatch):
    """A slab above the crossing of the two routes' planned peaks takes the
    tiled engines (the unfused cap left as it is), bitwise the monolithic
    filter; below it, the monolithic filter. TILE_VOX_BUDGET is shrunk so
    that the crossing falls under this small volume's slabs."""
    import pnr_tpu_torch.parallel.sharded as sharded

    make, sig = FRANGI_CASES["clean"]
    vol = make()
    want = frangi3d(torch.from_numpy(vol), sig, ZDIST)
    calls = []
    tiled = sharded.frangi3d_tiled
    monkeypatch.setattr(sharded, "frangi3d_tiled", lambda *a, **k: calls.append(1) or tiled(*a, **k))
    shards = shard_volume(vol, mesh)
    slab = halo_exchange_z_aligned(shards, sharded.frangi_halo(sig, ZDIST))[0][0]
    assert not sharded.slab_filter_route(slab.shape, sig, ZDIST).tiled
    frangi3d_sharded(shards, sig, ZDIST, mesh)
    assert not calls
    monkeypatch.setattr(reconstruct, "TILE_VOX_BUDGET", 40_000)
    route = sharded.slab_filter_route(slab.shape, sig, ZDIST)
    assert route.tiled and route.blocks is not None
    assert route.peak_bytes < reconstruct.UNFUSED_PEAK_BYTES_PER_VOXEL * slab.numel()
    assert slab.numel() < reconstruct.UNFUSED_MAX_VOXELS
    j, jmin, jmax, vx, vy, vz = frangi3d_sharded(shards, sig, ZDIST, mesh)
    assert len(calls) == N
    for a, b in zip((j, vx, vy, vz), (want[0], want[3], want[4], want[5])):
        assert torch.equal(torch.cat(a), b)
    assert torch.equal(jmin, want[1]) and torch.equal(jmax, want[2])


@pytest.mark.parametrize("case", list(FRANGI_CASES))
def test_frangi3d_sharded_matches_jax_sharded(jmesh, mesh, case):
    make, sig = FRANGI_CASES[case]
    vol = make()
    ref = tuple(np.asarray(a) for a in jax_frangi3d_sharded(
        jax_shard_volume(vol, jmesh), sig, ZDIST, jmesh))
    j, jmin, jmax, vx, vy, vz = frangi3d_sharded(shard_volume(vol, mesh), sig, ZDIST, mesh)
    got = (stack(j), jmin.numpy(), jmax.numpy(), stack(vx), stack(vy), stack(vz))
    FRANGI_CHECKS[case](ref, got)


def plane(shape=(1, 48, 96), seed=5, yc=24.0):
    """tests/test_parallel.py's TestSharded2D image."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.arange(shape[1]), np.arange(shape[2]), indexing="ij")
    along = (0.7 + 0.3 * np.sin(x / 4.0)) * (x > 6) * (x < shape[2] - 7)
    img = 200.0 * np.exp(-((y - yc) ** 2) / (2 * 2.5**2)) * along
    img = img + rng.normal(0, 5, (shape[1], shape[2]))
    return np.clip(img, 0, 255).astype(np.uint8)[None]


@pytest.mark.parametrize("route", ["monolithic", "tiled"])
def test_frangi2d_sharded_bitwise_monolithic(mesh, monkeypatch, route):
    vol = plane()
    sig = (2.0, 3.0)
    j0, jmin0, jmax0, vx0, vy0, _ = frangi2d(torch.from_numpy(vol[0]), sig)
    _route(monkeypatch, route)
    vt = np.ascontiguousarray(vol.transpose(1, 0, 2))  # (Y, 1, X)
    j, jmin, jmax, vx, vy, vz = frangi2d_sharded(shard_volume(vt, mesh), sig, mesh)
    assert torch.equal(torch.cat(j)[:, 0], j0)
    assert torch.equal(torch.cat(vx)[:, 0], vx0) and torch.equal(torch.cat(vy)[:, 0], vy0)
    assert not torch.cat(vz).any()
    assert torch.equal(jmin, jmin0) and torch.equal(jmax, jmax0)
    j8 = stack(normalize_to_u8_sharded(j, jmin, jmax))[:, 0]
    from pnr_tpu_torch.ops.frangi import normalize_to_u8

    np.testing.assert_array_equal(j8, normalize_to_u8(j0, jmin0, jmax0).numpy())


# -- boundary handoff -------------------------------------------------------------


def spanning_volume():
    """tests/test_parallel.py's TestHandoffTracing volume: a tube along z."""
    rng = np.random.default_rng(9)
    shape = (32, 24, 64)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 12) ** 2 + (x - 32) ** 2
    return np.clip(200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.75 + 0.25 * np.sin(z / 3.0))
                   + rng.normal(0, 4, shape), 0, 255).astype(np.uint8)


def spanning_cfg(mode):
    return PNRConfig(sigmas=(2.0,), znccth=0.3, kappa=2.0, step=2, ni=16, np=8, zdist=1.0,
                     nodepervol=4, vol=9, zncc_mode=mode)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_z_spanning_trace_bitwise_single_device(mesh, mode):
    """A trace seeded in shard 0, headed +z, is handed from shard to shard
    and stays bitwise the port's single-device trace (same key)."""
    vol, cfg, lanes = spanning_volume(), spanning_cfg(mode), 4
    stage_iters = 2
    step, _, _ = build_handoff_trace_step(cfg, mesh, lanes, stage_iters)
    seeds = np.zeros((N * lanes, 3), np.float32)
    dirs = np.zeros((N * lanes, 3), np.float32)
    dirs[:, 0] = 1.0
    ids = np.arange(N * lanes)
    valid = np.zeros(N * lanes, bool)
    seeds[0], dirs[0], valid[0] = (32.0, 12.0, 2.0), (0.0, 0.0, 1.0), True
    key = tf.key_from_seed(0)
    packs, sids, _, lost = step(shard_volume(vol, mesh), seeds, dirs, ids, valid, key)
    assert not lost.any()
    est, tids = stitch_estimates(packs, sids, cfg.ni)
    got = est[list(tids).index(0)]
    shards = {int(np.nonzero(row == 0)[0][0]) // lanes for row in sids if (row == 0).any()}
    assert len(shards) >= 2, "the trace never left shard 0"

    tracker = BatchedTracker(cfg, "cpu", stage_iters=stage_iters)
    field = tracker.prepare_field(torch.from_numpy(vol))
    keys = trace_keys(key, ids[:1])
    carry, e0 = tracker.trace_init(field, seeds[:1], dirs[:1], keys)
    rows, it = [e0.numpy()[:, None]], 1
    while it < cfg.ni:
        n = min(stage_iters, cfg.ni - it)
        carry, pk = tracker.trace_stage(field, keys, carry, it, n, torch.zeros(1, dtype=torch.bool))
        rows.append(pk.numpy())
        it += n
    ref = np.concatenate(rows, axis=1)[0]
    ref[:, 8] = np.minimum.accumulate(ref[:, 8])
    ok = ref[:, 8] > 0.5
    assert ok.sum() >= 8 and ref[ok, 2].max() > 8, "the reference trace stays in shard 0"
    np.testing.assert_array_equal(got[:, 8], ref[:, 8])
    np.testing.assert_array_equal(got[ok], ref[ok])


def kept_local(packs, ids, lanes, zl, ni):
    """Movers a stage kept on their shard, read from the one-shot blocks: a
    live, alive lane whose last centroid lies in another shard's slab and
    whose trace is still in that lane at the next stage (the handoff's
    `kept_local`, summed over stages and shards)."""
    stage_iters, n = packs.shape[2], ids.shape[1] // lanes
    kept = 0
    for s in range(packs.shape[0] - 1):
        last = 0 if s == 0 else min(stage_iters, ni - 1 - (s - 1) * stage_iters) - 1
        for lane in np.nonzero(ids[s] >= 0)[0]:
            row = packs[s, lane, last]
            owner = min(max(int(np.floor(row[2] / zl)), 0), n - 1)
            kept += int(row[8] > 0.5 and owner != lane // lanes and ids[s + 1, lane] == ids[s, lane])
    return kept


def test_lane_overflow_keeps_traces_local(mesh):
    """With one lane per shard, every migration lands on a full shard: the
    movers stay local (kept_local > 0), no trace is lost, and the traced
    work stays comparable to a run with free lanes (JAX's
    test_lane_overflow_loses_zero_traces)."""
    vol, cfg = spanning_volume(), spanning_cfg("tube")
    zl = vol.shape[0] // N
    seeds = np.array([[32.0, 12.0, 8.0 * s + 2.0] for s in range(N)], np.float32)
    dirs = np.tile(np.float32([[0.0, 0.0, 1.0]]), (N, 1))
    ids, key = np.arange(N), tf.key_from_seed(0)
    step, _, _ = build_handoff_trace_step(cfg, mesh, 1, 2)
    packs, sids, _, lost = step(shard_volume(vol, mesh), seeds, dirs, ids, np.ones(N, bool), key)
    assert kept_local(packs, sids, 1, zl, cfg.ni) > 0 and not lost.any()
    est, got_ids = stitch_estimates(packs, sids, cfg.ni)
    assert sorted(got_ids.tolist()) == list(range(N))
    narrow = (est[:, :, 8] > 0.5).sum()

    wide_lanes = 4
    sp = np.zeros((N * wide_lanes, 3), np.float32)
    sd = np.tile(np.float32([[1.0, 0.0, 0.0]]), (N * wide_lanes, 1))
    valid = np.zeros(N * wide_lanes, bool)
    sp[::wide_lanes], sd[::wide_lanes], valid[::wide_lanes] = seeds, dirs, True
    tid = np.repeat(ids, wide_lanes)
    step_w, _, _ = build_handoff_trace_step(cfg, mesh, wide_lanes, 2)
    packs_w, sids_w, _, _ = step_w(shard_volume(vol, mesh), sp, sd, tid, valid, key)
    assert kept_local(packs_w, sids_w, wide_lanes, zl, cfg.ni) == 0
    est_w, _ = stitch_estimates(packs_w, sids_w, cfg.ni)
    assert narrow >= 0.5 * (est_w[:, :, 8] > 0.5).sum()


# -- the engines under a slab frame (their plain versions) ---------------------------


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_engines_read_a_slab_as_the_whole_field(mode):
    """Under a SlabFrame the exact and tube engines compute, for windows
    inside the slab, bitwise what they compute on the whole field."""
    from pnr_tpu_torch.ops.slab import SlabFrame
    from pnr_tpu_torch.ops.zncc_exact import ExactPatchEngine
    from pnr_tpu_torch.ops.zncc_fast import TubePatchEngine, build_tube_maps_packed
    from pnr_tpu_torch.ops.zncc_model import TubeZnccModel, ZnccTemplates

    shape, z0, z1 = (64, 40, 64), 10, 54
    vol = torch.from_numpy(volume(shape, seed=4))
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(np.stack([rng.uniform(16, 48, (6, 5)), rng.normal(20, 1.5, (6, 5)),
                                     rng.normal(32, 1.0, (6, 5))], -1).astype(np.float32))
    d = torch.from_numpy(np.tile(np.float32([1.0, 0.0, 0.0]), (6, 5, 1)))
    frame = SlabFrame((z0, 0, 0), shape)
    if mode == "tube":
        model = TubeZnccModel((2.0, 3.0), False)
        field = build_tube_maps_packed(vol, model)
        slab = field[:, z0:z1].contiguous()
        eng = TubePatchEngine(model, 2, ZDIST, device="cpu")
        corners = eng.window(slab, pos.mean(dim=1), frame=frame)
        assert torch.equal(corners, eng.window(field, pos.mean(dim=1)))
        assert torch.equal(eng.likelihood(slab, corners, pos, d, frame=frame)[0],
                           eng.likelihood(field, corners, pos, d)[0])
    else:
        field, slab = vol, vol[z0:z1].contiguous()
        eng = ExactPatchEngine(ZnccTemplates((2.0, 3.0), False), 2, "cpu")
    whole, part = eng.eval_fused(field, pos, d), eng.eval_fused(slab, pos, d, frame)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])
