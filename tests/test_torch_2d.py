"""The port's 2-D (one-plane) path against the JAX package, on the CPU.

The same seeded numpy planes and queries go through `pnr_tpu` and through
the port's plain versions:
* `hessian2d` and `frangi2d` at the bars tests/test_torch_frangi.py holds
  `frangi3d` to (J within 1e-4 of Jmax, Jmin and Jmax too, J8 within 8 on
  under 1% of pixels, directions aligned);
* `frangi2d_tiled` bitwise the port's `frangi2d` at two forced block
  shapes (one that does not divide the plane), and `pick_blocks_2d`
  equal to JAX's;
* `trilinear` at l == 1 equal to JAX's bilinear branch;
* the exact engine on a one-plane patch (pz = 1) against JAX's XLA engine
  (`force_xla`), at the bars of tests/test_torch_zncc_exact.py
  (correlation atol 3e-4, argmax sigma equal on more than 97%);
* the tube map build on a (1, Y, X) plane (y and x passes only) within
  2e-6 of JAX's, and the tube engine (windows, extract + corr,
  eval_fused) at the bars of tests/test_torch_zncc_fast.py (atol 2e-5,
  sigma agreement > 0.99), with `tube_corr`'s routes bitwise its plain
  chain as tests/test_torch_tube_corr.py holds them.
The pipeline end to end is in tests/test_torch_2d_pipeline.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import STEP, as_numpy, dirs_aligned, j8_of, plane_tube, queries_2d
from pnr_tpu.ops import zncc_fast as jzf
from pnr_tpu.ops.frangi import frangi2d as jax_frangi2d
from pnr_tpu.ops.frangi_blocked import pick_blocks_2d as jax_pick_blocks_2d
from pnr_tpu.ops.hessian import hessian2d as jax_hessian2d
from pnr_tpu.ops.interp import trilinear as jax_trilinear
from pnr_tpu.ops.zncc_exact import make_exact_patch_engine
from pnr_tpu.ops.zncc_model import TubeZnccModel, ZnccTemplates
from pnr_tpu_torch.ops import tube_corr as tc
from pnr_tpu_torch.ops import zncc_fast as pzf
from pnr_tpu_torch.ops.frangi import frangi2d
from pnr_tpu_torch.ops.frangi_blocked import frangi2d_tiled, pick_blocks_2d
from pnr_tpu_torch.ops.hessian import hessian2d
from pnr_tpu_torch.ops.interp import trilinear
from pnr_tpu_torch.ops.zncc_exact import ExactPatchEngine, exact_sums_plain, slab_plan


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PLANES = {
    "line": lambda: plane_tube()[0],
    "line_steep_ragged": lambda: plane_tube((1, 61, 83), angle=1.1, seed=6)[0],
    "noisy": lambda: np.clip(plane_tube((1, 64, 80), seed=7)[0].astype(np.int32)
                             + np.random.default_rng(7).integers(0, 40, (64, 80)),
                             0, 255).astype(np.uint8),
}
SIGMAS = {"line": (2.0, 3.0), "line_steep_ragged": (2.0, 4.0, 6.0), "noisy": (2.0, 3.0)}


@pytest.mark.parametrize("sigma", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("case", list(PLANES))
def test_hessian2d_matches_jax(case, sigma):
    img = PLANES[case]()
    want = [np.asarray(a) for a in jax_hessian2d(jnp.asarray(img), sigma)]
    got = [a.numpy() for a in hessian2d(torch.from_numpy(img), sigma)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12)


@functools.lru_cache(maxsize=None)
def jax_frangi(case):
    return tuple(np.asarray(a) for a in jax_frangi2d(jnp.asarray(PLANES[case]()), SIGMAS[case]))


@pytest.mark.parametrize("case", list(PLANES))
def test_frangi2d_matches_jax(case):
    """The clean lines at `check_clean`'s J bars, the noisy plane at
    `check_noisy`'s (tests/_torch_cases.py): on noise, where |lambda1| is
    near 0, the ulp-level differences of the Gaussian move J by up to
    3e-4 of Jmax (measured), as they do in 3-D."""
    j0, jmin0, jmax0, *v0 = jax_frangi(case)
    j1, jmin1, jmax1, *v1 = as_numpy(frangi2d(torch.from_numpy(PLANES[case]()), SIGMAS[case]))
    scale = max(float(jmax0), 1e-12)
    assert j1.shape == j0.shape and j1.dtype == np.float32
    if case != "noisy":
        assert np.abs(j0 - j1).max() / scale < 1e-4
        assert abs(float(jmin0) - float(jmin1)) / scale < 1e-4
        assert abs(float(jmax0) - float(jmax1)) / scale < 1e-4
    j8a, j8b = j8_of(j0, jmin0, jmax0), j8_of(j1, jmin1, jmax1)
    assert np.abs(j8a - j8b).max() <= 8 and (j8a != j8b).mean() < 0.01
    assert not v1[2].any() and not v0[2].any()  # Vz is 0
    med, frac = dirs_aligned(j0, jmax0, v0[:2], v1[:2])
    assert med > 0.99 and frac > 0.95


def test_frangi2d_keeps_the_first_scale():
    img = torch.from_numpy(PLANES["line"]())
    out = frangi2d(img, (2.0, 3.0), keep_first_scale=True)
    first = frangi2d(img, (2.0,))[0]
    assert len(out) == 7 and torch.equal(out[6], first)
    assert float(out[1]) == float(first.min())


@pytest.mark.parametrize("blocks", [(32, 48), (24, 37)])  # dividing and ragged
def test_frangi2d_tiled_is_bitwise_frangi2d(blocks):
    img = torch.from_numpy(plane_tube((1, 96, 148), angle=0.6, seed=9)[0])
    sig = (2.0, 3.0)
    mono = frangi2d(img, sig)
    got = frangi2d_tiled(img, sig, block_y=blocks[0], block_x=blocks[1])
    for i in (0, 3, 4):
        assert torch.equal(got[i], mono[i])
    assert float(got[1]) == float(mono[1]) and float(got[2]) == float(mono[2])


def test_frangi2d_tiled_of_one_tile_is_frangi2d():
    img = torch.from_numpy(PLANES["line"]())
    got = frangi2d_tiled(img, (2.0,), block_y=4096, block_x=4096)
    mono = frangi2d(img, (2.0,))
    assert len(got) == 5 and all(torch.equal(a, b) for a, b in zip(got, mono[:5]))


@pytest.mark.parametrize("shape", [(80, 112), (4096, 4096), (9216, 9216), (300, 20000),
                                   (20000, 250)])
def test_pick_blocks_2d_matches_jax(shape):
    for sig in ((2.0, 3.0), (2.0, 4.0, 6.0)):
        assert pick_blocks_2d(shape, sig) == jax_pick_blocks_2d(shape, sig)


def test_trilinear_at_one_plane_matches_jax():
    img = plane_tube((1, 61, 83), angle=1.1, seed=6)
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 86, 500).astype(np.float32)
    y = rng.uniform(-3, 64, 500).astype(np.float32)
    z = rng.uniform(-2, 2, 500).astype(np.float32)  # ignored at l == 1
    x[:4], y[:4] = (0.0, 82.0, 0.0, 82.0), (0.0, 60.0, 60.0, 0.0)
    want = np.asarray(jax_trilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(z)))
    got = trilinear(torch.from_numpy(img)[None], *(torch.from_numpy(a)[None] for a in (x, y, z)))
    np.testing.assert_array_equal(got[0].numpy(), want)


# -- the exact engine on one plane -------------------------------------------

EXACT_PLANES = {
    "line": lambda: plane_tube((1, 96, 112), seed=5),
    "random": lambda: np.random.default_rng(5).integers(0, 256, (1, 48, 64), dtype=np.uint8),
    # h and w under the patch: py == h and px == w
    "small": lambda: np.random.default_rng(8).integers(0, 256, (1, 20, 30), dtype=np.uint8),
}


@pytest.mark.parametrize("sigmas", [(2.0, 3.0), (2.0, 4.0, 6.0)])
@pytest.mark.parametrize("case", list(EXACT_PLANES))
def test_exact_engine_on_one_plane_matches_jax(case, sigmas):
    vol = EXACT_PLANES[case]()
    pos, d = queries_2d(vol.shape, edges=case == "small")
    tmpl = ZnccTemplates(sigmas, is2d=True)
    jeng = make_exact_patch_engine(tmpl, step=STEP, force_xla=True)
    want_c, want_s = (np.asarray(a) for a in jeng.eval_fused(
        jnp.asarray(vol)[None], jnp.asarray(pos), jnp.asarray(d)))
    peng = ExactPatchEngine(tmpl, STEP, "cpu")
    assert peng.dims(vol.shape)[0] == 1
    got_c, got_s = peng.eval_fused(torch.from_numpy(vol), torch.from_numpy(pos),
                                   torch.from_numpy(d))
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=3e-4)
    assert (got_s.numpy() == want_s).mean() > 0.97


def test_exact_one_plane_queries_pin_z():
    """qinfo on a one-plane volume: rz and its bound are 0, so every
    sample's floor is plane 0; the slab plan is one slab of one plane."""
    vol = torch.from_numpy(EXACT_PLANES["line"]())
    pos, d = (torch.from_numpy(a) for a in queries_2d(tuple(vol.shape)))
    pos[..., 2] = 0.4  # off the plane: ignored
    eng = ExactPatchEngine(ZnccTemplates((2.0, 3.0), is2d=True), STEP, "cpu")
    corner = eng.corners(vol.shape, pos.mean(dim=1))
    qs = eng.qinfo(vol, corner, pos, d)
    assert bool((qs[..., 0] == 0).all()) and bool((qs[..., 12] == 0).all())
    dims = eng.dims(vol.shape)
    plan = slab_plan(dims, 100_000)
    assert (plan.nz, plan.step) == (1, 0) and plan.bounds(1) == [(0, 1)]
    sums = exact_sums_plain(vol, corner, qs, eng.tables, dims)
    assert bool(torch.isfinite(sums).all()) and bool((sums[..., 3] == 0).all())


# -- the tube engine on one plane ------------------------------------------------

TUBE_PLANES = {"line": (1, 64, 96), "small": (1, 12, 14)}


@functools.lru_cache(maxsize=None)
def plane(shape):
    return plane_tube(shape, seed=11)


@functools.lru_cache(maxsize=None)
def jax_packed_2d(shape, sigmas):
    return np.asarray(jzf.build_tube_maps_packed(jnp.asarray(plane(shape)),
                                                 TubeZnccModel(sigmas, True)))


@pytest.mark.parametrize("sigmas", [(2.0, 3.0), (2.0, 4.0, 6.0)])
def test_plane_map_build_matches_jax(sigmas):
    shape = TUBE_PLANES["line"]
    got = pzf.build_tube_maps_packed(torch.from_numpy(plane(shape)), TubeZnccModel(sigmas, True))
    want = jax_packed_2d(shape, sigmas)
    assert tuple(got.shape) == want.shape == (len(sigmas), 1, shape[1], 3 * shape[2])
    assert float((np.abs(got.numpy() - want) / np.maximum(np.abs(want), 1.0)).max()) < 2e-6


def test_plane_map_build_skips_the_z_pass():
    """The 2-D model's maps are the y-x correlations of the plane: no z
    pass (on one plane an edge-replicated z pass would only rescale M1)."""
    shape = TUBE_PLANES["line"]
    img = torch.from_numpy(plane(shape))
    model = TubeZnccModel((2.0,), True)
    m1, m2, m3 = next(pzf._tube_map_planes(img, model))
    from pnr_tpu_torch.ops.conv import conv1d_axis_plain

    k = model.gauss_kernels[0]
    want = conv1d_axis_plain(conv1d_axis_plain(img.float(), k, 2), k, 1)
    assert torch.equal(m1, want)


def engines_2d(sigmas, reuse=1):
    model = TubeZnccModel(sigmas, True)
    return (jzf.make_tube_patch_engine(model, STEP, 1.0, reuse=reuse),
            pzf.TubePatchEngine(model, STEP, 1.0, reuse=reuse, device="cpu"))


@pytest.mark.parametrize("case,sigmas,reuse", [
    ("line", (2.0, 3.0), 1), ("line", (2.0, 3.0), 3), ("line", (2.0, 4.0, 6.0), 1),
    ("small", (2.0, 3.0), 1),
])
def test_plane_extract_and_corr_match_jax(case, sigmas, reuse):
    shape = TUBE_PLANES[case]
    jeng, peng = engines_2d(sigmas, reuse)
    maps = jax_packed_2d(shape, sigmas)
    field = pzf.field_from_numpy(maps, "cpu")
    pos, d = queries_2d(shape, t=6, n=15, seed=2, edges=case == "small")
    centre = pos.mean(axis=1)
    jp, jc = jeng.extract(jnp.asarray(maps), jnp.asarray(centre))
    want_c, want_s = jeng.corr(shape, jp, jc, jnp.asarray(pos), jnp.asarray(d))
    pp, pc = peng.extract(field, torch.from_numpy(centre))
    assert [tuple(p.shape) for p in pp] == [tuple(np.shape(p)) for p in jp]
    assert all(p.shape[2] == 1 for p in pp)  # one-plane windows
    for a, b in zip(pc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got_c, got_s = peng.corr(shape, pp, pc, torch.from_numpy(pos), torch.from_numpy(d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=2e-5)
    assert (got_s.numpy() == np.asarray(want_s)).mean() > 0.99
    # tube_corr's tracer route: bitwise the extract + corr chain
    corners = peng.window(field, torch.from_numpy(centre))
    lay = peng.layout(field)
    out, _ = tc.tube_corr(field, lay.groups, corners, torch.from_numpy(pos), torch.from_numpy(d),
                          peng.tables)
    assert torch.equal(out[0], got_c) and torch.equal(out[1], got_s)


@pytest.mark.parametrize("case", list(TUBE_PLANES))
def test_plane_eval_fused_matches_jax(case):
    shape, sigmas = TUBE_PLANES[case], (2.0, 3.0)
    jeng, peng = engines_2d(sigmas)
    maps = jax_packed_2d(shape, sigmas)
    pos, d = queries_2d(shape, t=150, n=1, seed=4)
    want_c, want_s = jeng.eval_fused(jnp.asarray(maps), jnp.asarray(pos), jnp.asarray(d))
    got_c, got_s = peng.eval_fused(pzf.field_from_numpy(maps, "cpu"), torch.from_numpy(pos),
                                   torch.from_numpy(d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=2e-5)
    assert (got_s.numpy() == np.asarray(want_s)).mean() > 0.99


def test_plane_rel_coords_pin_z():
    shape = TUBE_PLANES["line"]
    eng = engines_2d((2.0, 3.0))[1]
    pos, d = (torch.from_numpy(a) for a in queries_2d(shape, t=4, n=5))
    pos[..., 2] = 0.7  # off the plane: ignored
    field = pzf.field_from_numpy(jax_packed_2d(shape, (2.0, 3.0)), "cpu")
    (g0, g1, pdims), = eng.groups(shape)[:1]
    corners = eng.window(field, pos.mean(dim=1))
    rel = tc.rel_coords(eng.tables, shape, pdims, corners[:, 0], pos, d, g0, g1)
    assert pdims[0] == 1 and bool((rel[..., 0] == 0).all())
