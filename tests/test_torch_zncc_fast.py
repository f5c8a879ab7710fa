"""Tube mode's modules (pnr_tpu_torch/ops/zncc_fast.py and the plain
chain of `tube_corr` in ops/tube_corr.py) against the JAX package, on the CPU.

The map builds are held to `build_tube_maps_packed*` at the bars of
tests/test_zncc.py (rel 2e-6; bfloat16 fields at most one bfloat16 ulp
apart). The engine runs on the JAX package's own field
(`field_from_numpy`), so that an engine mismatch is not read as a build
mismatch, and is held to JAX's XLA path: correlation atol 2e-5 and the
argmax sigma equal on more than 99% of queries. The plain K5/K6 are held
to the Pallas kernels in interpret mode at atol 5e-5. The CUDA kernel is
held to this plain chain in tests/test_torch_kernels.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import ENGINE_CASES, noisy_tube, tube_queries
from pnr_tpu.config import PNRConfig
from pnr_tpu.ops import zncc_fast as jzf
from pnr_tpu.ops.pallas_sample import hat_sample_fused, hat_sample_pallas
from pnr_tpu.ops.zncc_model import TubeZnccModel
from pnr_tpu_torch.ops import zncc_fast as pzf
from pnr_tpu_torch.ops.tube_corr import hat_sample_field_plain, hat_sample_patch_plain
from pnr_tpu_torch.smc.tracker import BatchedTracker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP, ZDIST = 2.0, 2.0


@functools.lru_cache(maxsize=None)
def volume(shape):
    return noisy_tube(shape)


@functools.lru_cache(maxsize=None)
def jax_packed(shape, sigmas):
    model = TubeZnccModel(sigmas, False)
    return np.asarray(jzf.build_tube_maps_packed(jnp.asarray(volume(shape)), model))


def rel_err(a, b):
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


@pytest.mark.parametrize("sigmas", [(2.0, 3.0), (2.0, 4.0, 6.0)])
def test_packed_build_matches_jax(sigmas):
    shape = (24, 64, 96)
    got = pzf.build_tube_maps_packed(torch.from_numpy(volume(shape)), TubeZnccModel(sigmas, False))
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), jax_packed(shape, sigmas)) < 2e-6


def test_packed_build_interleaves_the_planar_one():
    """packed[s, z, y, 3x + c] == planar[3s + c, z, y, x], exactly."""
    model = TubeZnccModel((2.0, 3.0), False)
    img = torch.from_numpy(volume((24, 64, 96)))
    planar = pzf.build_tube_maps(img, model).numpy()
    s3, l, h, w = planar.shape
    want = np.moveaxis(planar.reshape(s3 // 3, 3, l, h, w), 1, -1).reshape(s3 // 3, l, h, 3 * w)
    np.testing.assert_array_equal(pzf.build_tube_maps_packed(img, model).numpy(), want)


@pytest.mark.parametrize("block_z", [16, 24])  # dividing and tail-clamped
def test_blocked_f32_build_matches_monolithic(block_z):
    model = TubeZnccModel((2.0, 3.0), False)
    img = torch.from_numpy(volume((40, 48, 96)))
    mono = pzf.build_tube_maps_packed(img, model).numpy()
    blk = pzf.build_tube_maps_packed_blocked(img, model, block_z=block_z)
    assert blk.dtype == torch.float32
    assert rel_err(blk.numpy(), mono) < 2e-6


def test_bf16_field_within_one_ulp_of_jax():
    model = TubeZnccModel((2.0, 3.0), False)
    img = volume((40, 48, 96))
    want = np.asarray(
        jzf.build_tube_maps_packed_blocked(jnp.asarray(img), model, dtype=jnp.bfloat16, block_z=16)
    ).astype(np.float32)
    got = pzf.build_tube_maps_packed_blocked(
        torch.from_numpy(img), model, dtype=torch.bfloat16, block_z=16
    )
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one bfloat16 ulp: 2^(exponent - 7) of the larger magnitude
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


def test_field_from_numpy_keeps_the_dtype():
    model = TubeZnccModel((2.0,), False)
    img = jnp.asarray(volume((24, 64, 96)))
    f32 = pzf.field_from_numpy(np.asarray(jzf.build_tube_maps_packed(img, model)), "cpu")
    bf16 = np.asarray(jzf.build_tube_maps_packed_blocked(img, model, dtype=jnp.bfloat16))
    got = pzf.field_from_numpy(bf16, "cpu")
    assert f32.dtype == torch.float32 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), bf16.astype(np.float32))


def engines(sigmas, reuse):
    model = TubeZnccModel(sigmas, False)
    return (
        jzf.make_tube_patch_engine(model, STEP, ZDIST, reuse=reuse),
        pzf.TubePatchEngine(model, STEP, ZDIST, reuse=reuse, device="cpu"),
    )


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_extract_and_corr_match_jax(case):
    shape, sigmas, reuse, edges = ENGINE_CASES[case]
    jeng, peng = engines(sigmas, reuse)
    maps = jax_packed(shape, sigmas)
    field = pzf.field_from_numpy(maps, "cpu")
    pos, d = tube_queries(shape, edges=edges)
    centre = pos.mean(axis=1)
    jp, jc = jeng.extract(jnp.asarray(maps), jnp.asarray(centre))
    want_c, want_s = jeng.corr(shape, jp, jc, jnp.asarray(pos), jnp.asarray(d))
    pp, pc = peng.extract(field, torch.from_numpy(centre))
    # the same windows, cut at the same corners
    assert [tuple(p.shape) for p in pp] == [tuple(np.shape(p)) for p in jp]
    for a, b in zip(pc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got_c, got_s = peng.corr(shape, pp, pc, torch.from_numpy(pos), torch.from_numpy(d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=2e-5)
    assert (got_s.numpy() == np.asarray(want_s)).mean() > 0.99


def test_window_groups_at_the_main_path_config():
    """sigmas (2,4,6), step 2, zdist 2 on the (128, 640, 640) stack."""
    model = TubeZnccModel((2.0, 4.0, 6.0), False)
    dims = (128, 640, 640)
    g1 = pzf.TubePatchEngine(model, 2.0, 2.0, reuse=1, device="cpu")
    g2 = pzf.TubePatchEngine(model, 2.0, 2.0, reuse=2, device="cpu")
    assert [g[2] for g in g1.groups(dims)] == [(16, 24, 24), (24, 24, 24), (24, 32, 32)]
    assert [g[:2] for g in g2.groups(dims)] == [(0, 1), (1, 3)]
    assert [g[2] for g in g2.groups(dims)] == [(16, 24, 24), (24, 32, 32)]
    assert g1.dims(dims) == (32, 32, 32)


@pytest.mark.parametrize("shape", [(24, 64, 96), (20, 12, 14)])
def test_eval_fused_matches_jax(shape):
    """B=1 queries, as seed scoring sends them: the port samples a sigma_max
    window through K6's plain version, JAX (on the CPU) the group windows."""
    sigmas = (2.0, 3.0)
    jeng, peng = engines(sigmas, 1)
    maps = jax_packed(shape, sigmas)
    pos, d = tube_queries(shape, t=150, n=1, seed=4)
    want_c, want_s = jeng.eval_fused(jnp.asarray(maps), jnp.asarray(pos), jnp.asarray(d))
    got_c, got_s = peng.eval_fused(
        pzf.field_from_numpy(maps, "cpu"), torch.from_numpy(pos), torch.from_numpy(d)
    )
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=2e-5)
    assert (got_s.numpy() == np.asarray(want_s)).mean() > 0.99


def test_global_gather_form_matches_jax():
    sigmas = (2.0, 3.0)
    model = TubeZnccModel(sigmas, False)
    img = volume((24, 64, 96))
    maps_j = jzf.build_tube_maps(jnp.asarray(img), model)
    pos, d = tube_queries(img.shape, t=40, n=1, seed=5)
    want_c, want_s = jzf.make_tube_zncc_fn(model)(maps_j, jnp.asarray(pos[:, 0]), jnp.asarray(d[:, 0]))
    got_c, got_s = pzf.make_tube_zncc_fn(model)(
        torch.from_numpy(np.array(maps_j)), torch.from_numpy(pos[:, 0]), torch.from_numpy(d[:, 0])
    )
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=2e-5)
    assert (got_s.numpy() == np.asarray(want_s)).mean() > 0.99


def random_rel(rng, t, s, m, pdims):
    pz, py, px = pdims
    rel = np.zeros((t, s, m, 4), np.float32)
    rel[..., 0] = rng.uniform(0, pz - 1.001, (t, s, m))
    rel[..., 1] = rng.uniform(0, py - 1.001, (t, s, m))
    rel[..., 2] = rng.uniform(0, px - 1.001, (t, s, m))
    return rel


def test_k5_plain_matches_pallas_interpret():
    rng = np.random.default_rng(42)
    t, s, pz, py, px, m = 2, 2, 8, 16, 24, 16
    patches = rng.normal(size=(t, s, pz, py, 3 * px)).astype(np.float32)
    rel = random_rel(rng, t, s, m, (pz, py, px))
    want = np.asarray(hat_sample_pallas(jnp.asarray(patches), jnp.asarray(rel), interpret=True))
    got = hat_sample_patch_plain(torch.from_numpy(patches), torch.from_numpy(rel)).numpy()
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=5e-5)
    assert (got[..., 3] == 0).all()


def test_k6_plain_matches_fused_interpret():
    rng = np.random.default_rng(43)
    t, s, pz, py, px, m = 3, 2, 8, 16, 24, 16
    l, h, w = 20, 40, 64
    maps = rng.normal(size=(s, l, h, 3 * w)).astype(np.float32)
    corners = np.stack(
        [rng.integers(0, l - pz, t), rng.integers(0, h - py, t), rng.integers(0, w - px, t)], -1
    ).astype(np.int32)
    rel = random_rel(rng, t, s, m, (pz, py, px)).reshape(t, s * m, 4)
    want = np.asarray(
        hat_sample_fused(
            jnp.asarray(maps), jnp.asarray(corners), jnp.asarray(rel), (pz, py, px), interpret=True
        )
    )
    got = hat_sample_field_plain(
        torch.from_numpy(maps), torch.from_numpy(corners), torch.from_numpy(rel), (pz, py, px)
    ).numpy()
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=5e-5)


def test_bf16_engine_tracks_f32():
    """The port's forced-bf16 field against its float32 field, through the
    tracker's engine (tests/test_zncc.py's bars: 8e-3, 3% flips)."""
    img = torch.from_numpy(volume((40, 48, 96)))
    pos, d = tube_queries((40, 48, 96), t=150, n=1, seed=6)
    out = {}
    for dt in ("f32", "bf16"):
        cfg = PNRConfig(
            sigmas=(2.0, 3.0), znccth=0.3, kappa=3.0, step=2, ni=8, np=10, zdist=2.0,
            nodepervol=4, vol=9, zncc_mode="tube", tube_map_dtype=dt,
        )
        tracker = BatchedTracker(cfg, "cpu")
        field = tracker.prepare_field(img)
        assert field.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)
        c, s = tracker.engine.eval_fused(field, torch.from_numpy(pos), torch.from_numpy(d))
        out[dt] = (c.numpy(), s.numpy())
    assert np.abs(out["bf16"][0] - out["f32"][0]).max() < 8e-3
    assert (out["bf16"][1] != out["f32"][1]).mean() < 0.03
