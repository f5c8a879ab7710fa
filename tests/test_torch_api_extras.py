"""The port's API-only modules against the JAX package, on the CPU.

Mirrors tests/test_parity_extras.py and tests/test_smc.py's `trace_wave`
cases, each against `pnr_tpu` on the same seeded inputs. Bars:
* `utils.stats`, `refine_blurring`, `group0`, `non_blurring_reference`
  and `soma_extraction_alt`: exact (the same NumPy code);
* `mean_shift` and `cluster_labels`: labels equal, points within 1e-5;
* `interpz` and `nearest_direction`: indices exact, values within 1e-5;
* `zncc_batch`/`make_zncc_fn`: corr within 3e-4 and sigma agreeing on
  more than 97% of queries (tests/test_torch_zncc_exact.py's bar);
* `extract3d_alt`: the same seed set;
* `trace_wave`: tests/test_torch_tracker.py's bar (every estimate column
  within 1e-3, sigma and valid exact), staged bitwise unstaged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnr_tpu.config import PNRConfig as JaxConfig
from pnr_tpu.graph import nodes as jax_nodes
from pnr_tpu.graph import refine as jax_refine
from pnr_tpu.ops import interp as jax_interp
from pnr_tpu.ops import zncc as jax_zncc
from pnr_tpu.pipeline import reconstruct as jax_reconstruct
from pnr_tpu.seeds import alt as jax_alt
from pnr_tpu.smc import clustering as jax_clustering
from pnr_tpu.smc import directions as jax_directions
from pnr_tpu.smc.tracker import BatchedTracker as JaxTracker
from pnr_tpu.utils import stats as jax_stats
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.graph import nodes, refine
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.ops import interp, zncc
from pnr_tpu_torch.ops.zncc_fast import field_from_numpy
from pnr_tpu_torch.ops.zncc_model import ZnccTemplates
from pnr_tpu_torch.pipeline import reconstruct
from pnr_tpu_torch.seeds import alt
from pnr_tpu_torch.smc import TraceResult, clustering, directions
from pnr_tpu_torch.smc.tracker import BatchedTracker
from pnr_tpu_torch.utils import stats


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (tests/test_torch_sharded.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tube_volume(shape=(12, 40, 60), seed=4, yc=20):
    """tests/test_parity_extras.py's alt-extractor tube, with x modulation."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - yc) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    return np.clip(200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.75 + 0.25 * np.sin(x / 4.0))
                   + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


# -- NumPy copies: exact ---------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("quantile", ([5, 1, 9, 3, 7], 1, 2)), ("quantile", ([5, 1, 9, 3, 7], 1, 1)),
    ("mode", ([3, 7, 7, 3],)), ("mode", ([],)), ("descending", (np.array([1.0, 5.0, 3.0, 5.0]),)),
    ("get_k_highest", (np.array([1.0, 5.0, 3.0, 4.0]), 2)),
    ("probability_distribution", (np.zeros(4),)), ("probability_distribution", (np.array([1.0, 3.0]),)),
])
def test_stats_equal_jax(name, args):
    got, want = getattr(stats, name)(*args), getattr(jax_stats, name)(*args)
    for g, w in zip(np.atleast_1d(np.asarray(got, dtype=object)), np.atleast_1d(np.asarray(want, dtype=object))):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def _node_lists(seed=0, n=40):
    """The same node list in both packages: a soma and a noisy line."""
    rng = np.random.default_rng(seed)
    rows = [(50.0, 50.0, 5.0, 4.0, 0.0, jax_nodes.SOMA)]
    rows += [(x, 10 + rng.normal(0, 1.0), 5.0 + rng.normal(0, 0.3), 2.0 + rng.random(), rng.random(), 3)
             for x in np.linspace(0, 40, n)]
    out = []
    for mod in (nodes, jax_nodes):
        nl = mod.NodeList()
        for x, y, z, s, c, t in rows:
            nl.add(x, y, z, sig=s, corr=c, ntype=t)
        for i in range(2, len(nl)):
            nl.nbr[i].append(i - 1)
            nl.nbr[i - 1].append(i)
        out.append(nl)
    return out


def _same_nodes(a, b):
    for f in ("x", "y", "z", "sig", "corr", "type", "nbr"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("name,args", [
    ("refine_blurring", (1.5, 4, 1e-4)), ("non_blurring_reference", (1.5, 4, 1e-4)),
    ("group0", (2.0, 1.0)),
])
def test_refiners_equal_jax(name, args):
    port, ref = _node_lists()
    _same_nodes(getattr(refine, name)(port, *args), getattr(jax_refine, name)(ref, *args))


def test_soma_extraction_alt_equals_jax():
    e8 = np.zeros((6, 30, 40), np.uint8)
    z, y, x = np.meshgrid(*[np.arange(s) for s in e8.shape], indexing="ij")
    for cx, cy in ((12, 10), (28, 20)):
        e8 = np.maximum(e8, (200 * np.exp(-((x - cx) ** 2 + (y - cy) ** 2 + (z - 3) ** 2) / 18.0)).astype(np.uint8))
    port_nodes, jax_nl = nodes.NodeList(), jax_nodes.NodeList()
    got = reconstruct.soma_extraction_alt(e8, 60, 3.0, 2.0, port_nodes)
    want = jax_reconstruct.soma_extraction_alt(e8, 60, 3.0, 2.0, jax_nl)
    assert len(port_nodes) > 2
    assert np.array_equal(got, want)
    _same_nodes(port_nodes, jax_nl)
    assert np.array_equal(reconstruct.sphere_offsets(2.5, 2.0), jax_reconstruct.sphere_offsets(2.5, 2.0))


# -- torch ops against XLA -------------------------------------------------------


def test_mean_shift_and_labels_match_jax():
    rng = np.random.default_rng(42)
    pts = np.concatenate([rng.normal(0, 0.3, (12, 3)), rng.normal(0, 0.3, (8, 3)) + [10, 0, 0],
                          rng.normal(0, 0.4, (6, 3)) + [0, 8, 2]]).astype(np.float32)
    conv = clustering.mean_shift(torch.from_numpy(pts), krad=3.0)
    conv_j = np.asarray(jax_clustering.mean_shift(jnp.asarray(pts), krad=3.0))
    np.testing.assert_allclose(conv.numpy(), conv_j, rtol=0, atol=1e-5)
    labels = clustering.cluster_labels(conv, dist=2.0)
    labels_j = np.asarray(jax_clustering.cluster_labels(jnp.asarray(conv_j), dist=2.0))
    assert labels.dtype == torch.int32 and np.array_equal(labels.numpy(), labels_j)
    assert len(np.unique(labels_j)) == 3
    w = rng.random(len(pts)).astype(np.float32)
    for a, b in zip(clustering.largest_cluster(labels.numpy(), w), jax_clustering.largest_cluster(labels_j, w)):
        assert np.array_equal(a, b)


def test_interpz_and_nearest_direction_match_jax():
    rng = np.random.default_rng(1)
    vol = (rng.random((5, 6, 7)) * 255).astype(np.uint8)
    x, y = rng.integers(0, 7, 50), rng.integers(0, 6, 50)
    z = rng.uniform(-0.5, 4.5, 50).astype(np.float32)
    got = interp.interpz(torch.from_numpy(vol), torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z))
    want = np.asarray(jax_interp.interpz(jnp.asarray(vol), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    one = vol[:1]
    np.testing.assert_array_equal(interp.interpz(torch.from_numpy(one), x, y, z).numpy(),
                                  np.asarray(jax_interp.interpz(jnp.asarray(one), x, y, z)))
    for is2d in (False, True):
        book = directions.generate_directions(is2d)
        d = rng.normal(size=(200, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        got = directions.nearest_direction(torch.from_numpy(d), book)
        want = np.asarray(jax_directions.nearest_direction(jnp.asarray(d), jnp.asarray(book)))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("is2d", [False, True])
def test_zncc_batch_matches_jax(is2d):
    vol = tube_volume()[6:7] if is2d else tube_volume()
    rng = np.random.default_rng(3)
    n = 700  # two chunks of ZNCC_CHUNK
    l, h, w = vol.shape
    pos = np.stack([rng.uniform(0, w - 1, n), rng.normal(20, 3, n),
                    np.zeros(n) if is2d else rng.uniform(0, l - 1, n)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if is2d:
        d[:, 2] = 0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tpl = ZnccTemplates((2.0, 3.0), is2d)
    corr, sig = zncc.make_zncc_fn(tpl)(torch.from_numpy(vol), pos, d)
    corr_j, sig_j = (np.asarray(a) for a in jax_zncc.make_zncc_fn(jax_zncc.ZnccTemplates((2.0, 3.0), is2d))(
        jnp.asarray(vol), jnp.asarray(pos), jnp.asarray(d)))
    assert zncc.ZNCC_CHUNK == jax_zncc.ZNCC_CHUNK
    assert corr.shape == (n,) and sig.shape == (n,)
    np.testing.assert_allclose(corr.numpy(), corr_j, rtol=0, atol=3e-4)
    assert (sig.numpy() == sig_j).mean() > 0.97


def test_extract3d_alt_same_seed_set_as_jax():
    vol = tube_volume()
    cfg = PNRConfig(sigmas=(2.0, 3.0), nodepervol=4, vol=9)
    pos, dirs, score, corr = alt.extract3d_alt(vol, cfg, j8_threshold=20, seed_corr_min=0.5, device="cpu")
    pj, dj, sj, cj = jax_alt.extract3d_alt(vol, JaxConfig(sigmas=(2.0, 3.0), nodepervol=4, vol=9),
                                           j8_threshold=20, seed_corr_min=0.5)
    assert len(pj) > 0
    assert {tuple(p) for p in pos.tolist()} == {tuple(p) for p in pj.tolist()}
    assert np.all(np.diff(score) <= 1e-6) and np.all(corr > 0.5)
    j, _, _, _, sc = alt.frangi3d_with_scale(torch.from_numpy(vol), cfg.sigmas, cfg.zdist)
    jj, _, _, _, scj = jax_alt.frangi3d_with_scale(jnp.asarray(vol), cfg.sigmas, cfg.zdist)
    assert sc.dtype == torch.uint8 and (sc.numpy() == np.asarray(scj)).mean() > 0.99
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=0, atol=1e-5 * float(np.max(jj)))


# -- the one-shot wave tracer ------------------------------------------------------

WAVE_CFG = dict(sigmas=(2.0, 3.0), znccth=0.3, kappa=3.0, step=2, ni=8, np=20, zdist=2.0,
                nodepervol=4, vol=9)
SEEDS = np.array([[10.0, 20.0, 6.0], [30.0, 20.0, 6.0], [45.0, 18.0, 5.0]], np.float32)
DIRS = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0.6, 0.8, 0]], np.float32)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_trace_wave_tracks_jax(mode):
    """The port's one-shot wave against JAX's on the same field (tube: the
    JAX tracer's own maps, as tests/test_torch_tracker.py does), same keys
    and trace ids."""
    vol = tube_volume()
    jt = JaxTracker(JaxConfig(**WAVE_CFG, zncc_mode=mode), False)
    f = jt.prepare_field(jnp.asarray(vol)) if mode == "tube" else jnp.asarray(vol)
    ids = np.array([3, 0, 7])
    want = jt.trace_wave(f, SEEDS, DIRS, jax.random.key(5), ids)
    port = BatchedTracker(PNRConfig(**WAVE_CFG, zncc_mode=mode), "cpu")
    field = field_from_numpy(np.asarray(f), "cpu") if mode == "tube" else torch.from_numpy(vol)
    got = port.trace_wave(field, SEEDS, DIRS, tf.key_from_seed(5), ids)
    assert isinstance(got, TraceResult) and got.pos.shape == (3, 8, 3)
    assert got.valid[:, :3].any()
    for name in ("pos", "dir", "corr"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-3)
    assert np.array_equal(got.sig, want.sig) and np.array_equal(got.valid, want.valid)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_trace_wave_staged_chunked_and_empty(mode):
    """staged=True bitwise staged=False; a trace's estimates do not depend
    on its chunk (TRACE_CHUNK 2 against 128); an empty wave is empty."""
    cfg = PNRConfig(**WAVE_CFG, zncc_mode=mode)
    port = BatchedTracker(cfg, "cpu", stage_iters=3)
    field = port.prepare_field(torch.from_numpy(tube_volume()))
    key, ids = tf.key_from_seed(1), np.array([0, 1, 2])
    a = port.trace_wave(field, SEEDS, DIRS, key, ids)
    b = port.trace_wave(field, SEEDS, DIRS, key, ids, staged=False)
    small = BatchedTracker(cfg, "cpu", trace_chunk=2, stage_iters=3)
    c = small.trace_wave(field, SEEDS, DIRS, key, ids)
    for other in (b, c):
        for name in ("pos", "dir", "sig", "corr", "valid"):
            assert np.array_equal(getattr(a, name), getattr(other, name)), name
    e = port.trace_wave(field, np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32), key,
                        np.zeros(0, np.int64))
    assert e.pos.shape == (0, cfg.ni, 3) and e.valid.shape == (0, cfg.ni)
