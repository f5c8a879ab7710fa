"""The port's device seed flood against the JAX package's, on the CPU.

`pnr_tpu_torch.seeds.extract.max_points_device` is JAX's label
propagation as torch ops. Bar: bitwise JAX's `max_points_device` on the
inputs of tests/test_seeds.py (the smooth images at tolerances 5, 10,
20, the plateau, the flat image, and the hostile inputs of
TestAdversarialFlood, their generators copied), and bitwise across
chunkings. With the native library reported missing in both packages,
the pipeline floods on the device in both, and a small exact phantom's
seed set from `reconstruction_func` is bitwise JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import test_phantom_neuron as phantom
from pnr_tpu import native as jax_native
from pnr_tpu.seeds import extract as jax_extract
from pnr_tpu_torch import native
from pnr_tpu_torch.seeds import extract


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (tests/test_torch_sharded.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth_random_slice(rng, shape=(48, 64), sigma=3.0):
    """tests/test_seeds.py's generator."""
    img = rng.random(shape)
    img = ndi.gaussian_filter(img, sigma)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def hostile(levels, scale):
    """TestAdversarialFlood's generator."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, levels, (4, 96, 96)).astype(np.int64) * scale).clip(0, 255).astype(np.uint8)


def plateau_kron():
    rng = np.random.default_rng(3)
    return np.kron(rng.integers(0, 8, (3, 12, 12)).astype(np.uint8) * 30, np.ones((1, 8, 8), np.uint8))


def _both(vol, tol):
    want = np.asarray(jax_extract.max_points_device(jnp.asarray(vol), float(tol)))
    got = extract.max_points_device(torch.from_numpy(vol), float(tol))
    assert got.dtype == torch.bool and got.shape == vol.shape
    return got.numpy(), want


@pytest.mark.parametrize("tol", [5.0, 10.0, 20.0])
def test_smooth_images_bitwise_jax(tol):
    rng = np.random.default_rng(42)
    vol = np.stack([smooth_random_slice(rng) for _ in range(3)])
    got, want = _both(vol, tol)
    assert want.sum() > 0
    assert np.array_equal(got, want)


def test_plateau_and_flat_bitwise_jax():
    # slices flood alone: the plateau and two flat slices in one stack
    img = np.full((3, 16, 16), 17, np.uint8)
    img[0] = 0
    img[0, 7:10, 7:10] = 100
    got, want = _both(img, 5.0)
    assert np.array_equal(got, want) and got.sum() == 1 and got[0, 8, 8]
    got, want = _both(plateau_kron(), 5.0)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", [(5, 50, 10), (2, 200, 10), (256, 1, 0)],
                         ids=["few-levels-noise", "binary-blobs", "tol-zero-noise"])
def test_hostile_inputs_bitwise_jax(case):
    levels, scale, tol = case
    vol = hostile(levels, scale)
    got, want = _both(vol, tol)
    assert np.array_equal(got, want)
    # the documented divergence from the sequential flood stays bounded
    assert got.sum() == native.max_finder_stack(vol, float(tol)).sum()


@pytest.mark.parametrize("planes", [1, 2, 5])
def test_chunked_equals_whole_stack(monkeypatch, planes):
    """A byte budget of `planes` planes a chunk floods bitwise the whole."""
    rng = np.random.default_rng(7)
    vol = np.concatenate([np.stack([smooth_random_slice(rng) for _ in range(3)]),
                          hostile(5, 50)[:, :48, :64]])
    whole = extract.max_points_device(torch.from_numpy(vol), 10.0)
    monkeypatch.setattr(extract, "FLOOD_BUDGET_BYTES", planes * extract.FLOOD_BYTES_PER_VOXEL * 48 * 64)
    assert torch.equal(extract.max_points_device(torch.from_numpy(vol), 10.0), whole)


def test_extract_seeds_and_decode_match_jax():
    rng = np.random.default_rng(1)
    vol = np.stack([smooth_random_slice(rng) for _ in range(2)])
    vx, vy, vz = (rng.integers(0, 256, vol.shape).astype(np.uint8) for _ in range(3))
    for use_device in (True, False):
        p, d = extract.extract_seeds(vol, vx, vy, vz, 10.0, use_device=use_device, device="cpu")
        pj, dj = jax_extract.extract_seeds(vol, vx, vy, vz, 10.0, use_device=use_device)
        assert np.array_equal(p, pj)
        assert np.array_equal(d, dj)
    got = extract.decode_directions(vx, vy, vz)
    want = jax_extract.decode_directions(vx, vy, vz)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


class _SeedsFlooded(Exception):
    pass


def test_no_native_pipeline_floods_on_device_bitwise_jax(monkeypatch):
    """Without the native library both packages flood on the device:
    the port through `max_points_device` (counted), never the sequential
    flood, and the raw seed set of `reconstruction_func` (what the flood
    hands to the direction decode; the run stops there) is JAX's."""
    from pnr_tpu.pipeline import reconstruction_func as jax_reconstruction
    from pnr_tpu_torch.pipeline import reconstruct
    from pnr_tpu_torch.pipeline import reconstruction_func as port_reconstruction

    calls, seeds = [], {}
    real = extract.max_points_device

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def no_sequential_flood(*a, **k):
        raise AssertionError("the sequential host flood ran")

    def stop_at_decode(name):
        def decode(vx, vy, vz, pos):
            seeds[name] = np.array(pos)
            raise _SeedsFlooded
        return decode

    monkeypatch.setattr(jax_native, "have_native", lambda: False)
    monkeypatch.setattr(native, "have_native", lambda: False)
    monkeypatch.setattr(extract, "max_points_device", counted)
    monkeypatch.setattr(native, "max_finder_2d", no_sequential_flood)
    monkeypatch.setattr(native, "max_finder_stack", no_sequential_flood)
    monkeypatch.setattr(reconstruct, "decode_directions_device", stop_at_decode("port"))
    monkeypatch.setattr(jax_extract, "decode_directions_device", stop_at_decode("jax"))
    vol, _ = phantom.branching_neuron_phantom()
    cfg = dataclasses.replace(phantom.CFG, zncc_mode="exact")
    with pytest.raises(_SeedsFlooded):
        port_reconstruction(vol, cfg, verbose=False, device="cpu")
    with pytest.raises(_SeedsFlooded):
        jax_reconstruction(vol, cfg, verbose=False)
    assert calls == [1]
    assert len(seeds["jax"]) > 10
    assert np.array_equal(seeds["port"], seeds["jax"])
