"""The unfused and tiled Frangi engines of the port against the JAX package.

On the CPU the port's `frangi3d` runs the plain chain; it is held to
JAX's `frangi3d` (with `keep_first_scale`) at the bars of
tests/_torch_cases.py. The port's `frangi3d_tiled` and `frangi3d_blocked`
must be bitwise its own monolithic `frangi3d`, as JAX's are JAX's
(tests/test_ops_dense.py, same shapes and blocks), and within the same
bars of JAX's tiled and blocked engines. The pipeline's routing of the
filter (`cfg.fused_frangi` and the caps) is checked on a small stack.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_cases import FRANGI_CASES, FRANGI_CHECKS, ZDIST, as_numpy, check_noisy
from pnr_tpu.ops import frangi_blocked as jfb
from pnr_tpu.ops.frangi import frangi3d as jax_frangi3d
from pnr_tpu_torch import PNRConfig
from pnr_tpu_torch.ops import frangi_blocked as pfb
from pnr_tpu_torch.ops.frangi import frangi3d
from pnr_tpu_torch.pipeline import reconstruct


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIGMAS = (2.0, 3.0)


@pytest.mark.parametrize("case", list(FRANGI_CASES))
def test_unfused_matches_jax_with_first_scale(case):
    make, sig = FRANGI_CASES[case]
    vol = make()
    want = [np.asarray(a) for a in jax_frangi3d(vol, sig, ZDIST, keep_first_scale=True)]
    got = as_numpy(frangi3d(torch.from_numpy(vol), sig, ZDIST, keep_first_scale=True))
    FRANGI_CHECKS[case](want[:6], got[:6])
    # the first scale's response, whose min is Jmin, at the same bars
    v1w, v1g = want[6], got[6]
    assert float(v1g.min()) == float(got[1])
    FRANGI_CHECKS[case]((v1w, v1w.min(), v1w.max(), *want[3:6]),
                        (v1g, v1g.min(), v1g.max(), *got[3:6]))


def noisy_tube(shape):
    """tests/test_ops_dense.py's make_tube_volume plus rng(42) noise."""
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] / 2.0) ** 2 + ((z - shape[0] / 2.0) * ZDIST) ** 2
    vol = np.clip(200.0 * np.exp(-d2 / (2 * 3.0**2)), 0, 255).astype(np.uint8)
    noise = np.random.default_rng(42).normal(0, 4, shape)
    return np.clip(vol.astype(np.int16) + noise, 0, 255).astype(np.uint8)


#: (engine, volume shape, blocks), as tests/test_ops_dense.py runs them
ENGINES = {
    "blocked_16": ("blocked", (46, 40, 48), {"block_z": 16}),
    "tiled_16_16": ("tiled", (48, 64, 48), {"block_z": 16, "block_y": 16}),
    "tiled_16_24": ("tiled", (48, 64, 48), {"block_z": 16, "block_y": 24}),
}


@functools.lru_cache(maxsize=None)
def port_monolithic(shape):
    return as_numpy(frangi3d(torch.from_numpy(noisy_tube(shape)), SIGMAS, ZDIST))


@pytest.mark.parametrize("name", list(ENGINES))
def test_tiled_engines_bitwise_monolithic_and_close_to_jax(name):
    engine, shape, blocks = ENGINES[name]
    vol = noisy_tube(shape)
    port_fn = pfb.frangi3d_tiled if engine == "tiled" else pfb.frangi3d_blocked
    jax_fn = jfb.frangi3d_tiled if engine == "tiled" else jfb.frangi3d_blocked
    got = as_numpy(port_fn(torch.from_numpy(vol), SIGMAS, ZDIST, **blocks))
    ref = port_monolithic(shape)
    for i in (0, 3, 4, 5):  # J, Vx, Vy, Vz
        np.testing.assert_array_equal(got[i], ref[i])
    assert float(got[1]) == float(ref[1])  # first-scale Jmin, bitwise
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-6)
    check_noisy([np.asarray(a) for a in jax_fn(vol, SIGMAS, ZDIST, **blocks)], got)


def test_blocked_shallow_volume_is_monolithic():
    vol = (np.random.default_rng(42).random((20, 16, 24)) * 255).astype(np.uint8)
    t = torch.from_numpy(vol)
    got = pfb.frangi3d_blocked(t, SIGMAS, ZDIST, block_z=8)[0]
    assert torch.equal(got, frangi3d(t, SIGMAS, ZDIST)[0])


@pytest.mark.parametrize(
    "shape", [(150, 2048, 2048), (128, 1024, 1024), (256, 768, 768), (534, 1024, 1024),
              (128, 640, 640), (24, 64, 96)],
)
def test_pick_blocks_and_halos_match_jax(shape):
    sig = (2.0, 4.0, 6.0)
    assert pfb.frangi_halo_z(sig, 2.0) == jfb.frangi_halo_z(sig, 2.0)
    assert pfb.frangi_halo_y(sig) == jfb.frangi_halo_y(sig)
    assert pfb.pick_blocks(shape, sig, 2.0) == jfb.pick_blocks(shape, sig, 2.0)
    assert pfb.pick_blocks(shape, SIGMAS, 2.0, 200_000) == jfb.pick_blocks(
        shape, SIGMAS, 2.0, 200_000)


def make_volume(shape=(24, 64, 96), seed=0):
    """bench.py's make_volume (the main path's stack, at a small shape)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] / 2) ** 2 + ((z - shape[0] / 2) * ZDIST) ** 2
    vol = 200.0 * np.exp(-d2 / (2 * 9.0)) * (0.7 + 0.3 * np.sin(x / 4.0))
    return np.clip(vol + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


ROUTE_CFG = PNRConfig(sigmas=SIGMAS, tolerance=10.0, znccth=0.5, kappa=3.0, step=2, ni=8,
                      np=20, zdist=ZDIST, nodepervol=4, vol=9, fused_frangi=False)


def test_routing_honours_fused_frangi_and_the_caps(monkeypatch):
    """fused_frangi picks K1's module; off, the monolithic unfused filter
    runs under its cap and the tiled engine above it, with the same J8
    and seeds; the seeds are JAX's."""
    from pnr_tpu.config import PNRConfig as JaxConfig
    from pnr_tpu.pipeline import reconstruction_func as jax_reconstruction

    vol = make_volume()
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(reconstruct, name, wrapped)

    for name in ("frangi3d_fused", "frangi3d", "frangi3d_tiled", "frangi3d_blocked"):
        spy(name, getattr(reconstruct, name))
    fused = reconstruct._stack_front(vol, dataclasses.replace(ROUTE_CFG, fused_frangi=True),
                                     torch.device("cpu"), verbose=False)
    mono = reconstruct._stack_front(vol, ROUTE_CFG, torch.device("cpu"), verbose=False)
    assert calls == ["frangi3d_fused", "frangi3d"]
    monkeypatch.setattr(reconstruct, "UNFUSED_MAX_VOXELS", vol.size - 1)
    monkeypatch.setattr(reconstruct, "TILE_VOX_BUDGET", 200_000)  # 2 tiles in y
    tiled = reconstruct._stack_front(vol, ROUTE_CFG, torch.device("cpu"), verbose=False)
    assert calls[2:] == ["frangi3d_tiled"]
    assert pfb.pick_blocks(vol.shape, SIGMAS, ZDIST, 200_000) == (24, 32)
    np.testing.assert_array_equal(tiled.j8_np, mono.j8_np)
    np.testing.assert_array_equal(fused.j8_np, mono.j8_np)
    np.testing.assert_array_equal(tiled.pos, mono.pos)
    # the fused flag set but the stack over K1's cap: the unfused routes
    monkeypatch.setattr(reconstruct, "FUSED_MAX_VOXELS", vol.size - 1)
    del calls[:]
    reconstruct._stack_front(vol, dataclasses.replace(ROUTE_CFG, fused_frangi=True),
                             torch.device("cpu"), verbose=False)
    assert calls == ["frangi3d_tiled"]
    ref = jax_reconstruction(vol, JaxConfig(**dataclasses.asdict(ROUTE_CFG)), verbose=False)
    assert {tuple(p) for p in tiled.pos.tolist()} == {tuple(p) for p in ref.seeds_pos.tolist()}
