"""The port's soma stage against the JAX package's, on the CPU.

The same seeded numpy inputs go through `pnr_tpu` and through the port's
plain versions: the morphology (`ops/morphology.py`), the xy and 2-D
Gaussians (`ops/gaussian.py`), the histogram thresholds
(`ops/thresholds.py`) and `soma_extraction` on `multi_neuron_soma_phantom`.
The pipeline with the soma stage is in tests/test_torch_soma_pipeline.py.

Bars: the morphology, the uint8 `imgaussian_xy` and the thresholds are
bitwise JAX's (the measured case: no uint8 voxel off by 1). The float32
`imgaussian2d` is within 1e-6 of max|JAX|: XLA groups the 2-D chain's
multiply-adds differently (measured max|d| 4.6e-05 on values up to 255,
under 2 ulp).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_phantoms as phantoms
import test_phantom_neuron as jax_phantom
from pnr_tpu.graph.nodes import NodeList as JaxNodeList
from pnr_tpu.ops import gaussian as jax_gaussian
from pnr_tpu.ops import morphology as jax_morphology
from pnr_tpu.ops import thresholds as jax_thresholds
from pnr_tpu.pipeline.reconstruct import smap_to_u8 as jax_smap_to_u8
from pnr_tpu.pipeline.reconstruct import soma_extraction as jax_soma_extraction
from pnr_tpu_torch.graph.nodes import SOMA, NodeList
from pnr_tpu_torch.ops import gaussian, morphology, thresholds
from pnr_tpu_torch.pipeline import reconstruct


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(3, 37, 53), (1, 64, 80), (5, 20, 9)]
CFG = dataclasses.replace(jax_phantom.CFG, zncc_mode="exact", ni=40, somaradius=4)


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("rad", [0, 1, 2.5, 4])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["imerode_xy", "imdilate_xy", "imerode_xyz"])
def test_morphology_is_bitwise_jax(name, shape, rad):
    v = _u8(shape)
    args = (rad, 2.0) if name == "imerode_xyz" else (rad,)
    want = np.asarray(getattr(jax_morphology, name)(jnp.asarray(v), *args))
    got = getattr(morphology, name)(torch.from_numpy(v), *args)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_morphology_on_float_is_bitwise_jax():
    v = np.random.default_rng(1).normal(size=(4, 30, 41)).astype(np.float32)
    want = np.asarray(jax_morphology.imerode_xyz(jnp.asarray(v), 3, 2.0))
    assert np.array_equal(morphology.imerode_xyz(torch.from_numpy(v), 3, 2.0).numpy(), want)


@pytest.mark.parametrize("sigma", [1.0, 2.5, 4.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_imgaussian_xy_is_bitwise_jax(shape, sigma):
    v = _u8(shape, seed=2)
    want = np.asarray(jax_gaussian.imgaussian_xy(jnp.asarray(v), sigma))
    got = gaussian.imgaussian_xy(torch.from_numpy(v), sigma)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("sigma", [1.0, 2.5, 4.0])
@pytest.mark.parametrize("shape", [(64, 80), (37, 53), (20, 9)])
def test_imgaussian2d_matches_jax(shape, sigma):
    v = _u8(shape, seed=3)
    want = np.asarray(jax_gaussian.imgaussian2d(jnp.asarray(v), sigma))
    got = gaussian.imgaussian2d(torch.from_numpy(v), sigma).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _histograms(kind, n=40, seed=0):
    """n seeded 256-bin histograms of one kind."""
    rng = np.random.default_rng([seed, ["random", "one_bin", "flat", "unimodal",
                                        "bimodal"].index(kind)])
    out = []
    for _ in range(n):
        if kind == "random":
            h = rng.integers(0, 1000, 256)
        elif kind == "one_bin":
            h = np.zeros(256, np.int64)
            h[rng.integers(0, 256)] = rng.integers(1, 10**6)
        elif kind == "flat":
            h = np.full(256, rng.integers(1, 1000))
        elif kind == "unimodal":
            x = rng.normal(rng.uniform(20, 200), rng.uniform(2, 40), 100_000)
            h = np.bincount(np.clip(x, 0, 255).astype(int), minlength=256)
        else:
            x = np.concatenate([rng.normal(40, 10, 50_000), rng.normal(180, 20, 5_000)])
            h = np.bincount(np.clip(x, 0, 255).astype(int), minlength=256)
        out.append(h.astype(np.int32))
    return out


THRESHOLDS = ["maxentropy_th", "otsu_th", "intermodes_th"]


#: histograms per kind: 200 per threshold. Intermodes smooths a flat, a
#: one-bin or a unimodal histogram 10,000 times before it gives up (-1),
#: about a second a call, so it takes fewer of those and more bimodal ones
COUNTS = {"random": 40, "one_bin": 40, "flat": 40, "unimodal": 40, "bimodal": 40}
INTERMODES_COUNTS = {"random": 40, "one_bin": 8, "flat": 4, "unimodal": 8, "bimodal": 140}


@pytest.mark.parametrize("kind", list(COUNTS))
@pytest.mark.parametrize("name", THRESHOLDS)
def test_thresholds_equal_jax_on_seeded_histograms(name, kind):
    """200 seeded histograms per threshold, of five kinds."""
    n = (INTERMODES_COUNTS if name == "intermodes_th" else COUNTS)[kind]
    for h in _histograms(kind, n):
        assert getattr(thresholds, name)(h) == getattr(jax_thresholds, name)(h), h


def _soma_e8():
    """The soma stage's eroded, smoothed stack of the soma phantom (JAX's)."""
    vol, _ = phantoms.multi_neuron_soma_phantom()
    r = float(CFG.somaradius)
    e8 = jax_morphology.imerode_xy(jnp.asarray(vol), r)
    return np.asarray(jax_gaussian.imgaussian_xy(e8, r))


@pytest.mark.parametrize("name", THRESHOLDS)
def test_thresholds_equal_jax_on_the_soma_phantom(name):
    e8 = _soma_e8()
    want = getattr(jax_thresholds, name)(e8)
    assert getattr(thresholds, name)(torch.from_numpy(e8)) == want
    assert getattr(thresholds, name)(e8) == want


def test_histogram256_matches_jax():
    v = _u8((7, 31, 33), seed=4)
    want = np.asarray(jax_thresholds.histogram256(jnp.asarray(v)))
    got = thresholds.histogram256(torch.from_numpy(v))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def _nodes_array(nodes):
    return np.stack([np.asarray(getattr(nodes, a)[1:], np.float64)
                     for a in ("x", "y", "z", "sig", "type")], axis=-1)


def test_soma_extraction_matches_jax():
    vol, _ = phantoms.multi_neuron_soma_phantom()
    jn = JaxNodeList()
    want = jax_soma_extraction(vol, CFG, jn)
    pn = NodeList()
    got = reconstruct.soma_extraction(vol, CFG, pn, "cpu")
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert len(pn) == len(jn) == 3  # the dummy node and two somas
    assert np.array_equal(_nodes_array(pn), _nodes_array(jn))
    assert all(t == SOMA for t in pn.type[1:])
    assert np.array_equal(reconstruct.smap_to_u8(got), jax_smap_to_u8(want))


def test_smap_to_u8_of_a_constant_map():
    m = np.full((2, 3, 4), 7, np.int32)
    assert np.array_equal(reconstruct.smap_to_u8(m), jax_smap_to_u8(m))
