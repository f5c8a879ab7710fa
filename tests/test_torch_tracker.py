"""The port's tracer (pnr_tpu_torch/smc/tracker.py) against the JAX
`BatchedTracker` in exact and tube mode: identical tables, bitwise
identical random streams, and the same early particle paths from the same
keys."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnr_tpu.config import PNRConfig
from pnr_tpu.hostpath import threefry as tf
from pnr_tpu.ops.zncc_exact import build_exact_bank
from pnr_tpu.smc.tracker import BatchedTracker as JaxTracker
from pnr_tpu_torch.ops import threefry
from pnr_tpu_torch.smc.tracker import BatchedTracker, tables_from_numpy, trace_keys


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = PNRConfig(
    sigmas=(2.0, 3.0), znccth=0.3, kappa=3.0, step=2, ni=12, np=20,
    zdist=2.0, nodepervol=4, vol=9, zncc_mode="exact",
)


def tube_volume(shape=(16, 48, 64), seed=11):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] // 2) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    return np.clip(
        200.0 * np.exp(-d2 / (2 * 3.0**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
        + rng.normal(0, 5, x.shape),
        0, 255,
    ).astype(np.uint8)


def test_tables_equal_jax_bit_for_bit():
    jt = JaxTracker(CFG, False)
    got = tables_from_numpy(jt.tables, jt.templates, "cpu")
    for name in ("p", "u", "w0", "w0_cws", "v", "w", "w_cws"):
        want = np.asarray(getattr(jt, "_" + name))
        have = getattr(got, name).numpy()
        assert have.dtype == np.float32 and want.dtype == np.float32, name
        assert np.array_equal(have, want), name
    # the template rows in the order of the JAX engine's bank (sorted by
    # (w, v, u)), zero-padded to the longest sigma
    tmpl = got.templates
    bank = build_exact_bank(jt.templates)
    for i, blocks in enumerate(bank.tables):
        k = int(jt.templates.cnt[i])
        rows = blocks.transpose(0, 2, 1).reshape(-1, 5)[:k]
        assert np.array_equal(tmpl.tab[i, :k].numpy(), rows[:, :4])
        assert not tmpl.tab[i, k:].numpy().any()
    assert np.array_equal(tmpl.cnt.numpy(), jt.templates.cnt.astype(np.int32))
    for name in ("avg", "corrc"):
        assert np.array_equal(getattr(tmpl, name).numpy(), getattr(jt.templates, name))


def test_float64_tables_are_cast_at_the_boundary():
    jt = JaxTracker(CFG, False)
    t64 = dataclasses.replace(jt.tables, w=jt.tables.w.astype(np.float64))
    got = tables_from_numpy(t64, jt.templates, "cpu")
    assert got.w.dtype == torch.float32
    assert np.array_equal(got.w.numpy(), jt.tables.w)


def test_keys_and_stage_uniforms_equal_jax_bitwise():
    """The tracer's (trace id, step) pattern: keys fold_in(key(seed), id),
    transition draws at step 2i, resampling offsets at step 2i+1."""
    ids = np.array([0, 1, 4, 5, 1002, 1003], np.int64)
    base = jax.random.key(CFG.seed)
    keys_j = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.asarray(ids, jnp.uint32))
    keys = trace_keys(tf.key_from_seed(CFG.seed), ids)
    assert np.array_equal(np.asarray(jax.random.key_data(keys_j)), keys)

    def jax_uniforms(step, shape):
        ks = jax.vmap(lambda k: jax.random.fold_in(k, step))(keys_j)
        return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(ks))

    # the port's stage draw (ops/threefry.py), on the CPU its plain version
    u1, ru = (a.numpy() for a in threefry.stage_draws(
        threefry.key_tensor(keys, "cpu"), torch.tensor(3, dtype=torch.int32), 4, CFG.np))
    for j, i in enumerate(range(3, 7)):
        assert np.array_equal(u1[j], jax_uniforms(2 * i, (CFG.np,)))
        assert np.array_equal(ru[j], jax_uniforms(2 * i + 1, ()))


def test_trace_init_and_stage_track_jax():
    vol = tube_volume()
    sp = np.array([[10.0, 24.0, 8.0], [30.0, 24.0, 8.0]], np.float32)
    sd = np.array([[1.0, 0, 0], [-1.0, 0, 0]], np.float32)
    keys = trace_keys(tf.key_from_seed(0), [0, 1])

    port = BatchedTracker(CFG, "cpu")
    field = torch.from_numpy(vol)
    carry, est0 = port.trace_init(field, sp, sd, keys)
    _, packed = port.trace_stage(field, keys, carry, 1, 7, torch.zeros(2, dtype=torch.bool))
    est0, packed = est0.numpy(), packed.numpy()

    jt = JaxTracker(CFG, False)
    f = jnp.asarray(vol)[None]
    keys_j = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(2, dtype=jnp.uint32)
    )
    carry_j, est0_j = jt._trace_init(f, jnp.asarray(sp), jnp.asarray(sd), keys_j)
    _, packed_j = jt._trace_stage(
        f, keys_j, carry_j, jnp.arange(1, 8), jnp.zeros(2, jnp.bool_)
    )
    est0_j, packed_j = np.asarray(est0_j), np.asarray(packed_j)

    # iteration 0: same systematic draw, same prior rows
    np.testing.assert_allclose(est0[:, :3], est0_j[:, :3], atol=0.35)
    # early iterations stay on the same path (chaotic later)
    np.testing.assert_allclose(packed[:, :2, :3], packed_j[:, :2, :3], atol=0.75)
    assert packed.shape == (2, 7, 9)
    assert np.isfinite(packed).all()
    # identical draws and tables: every column of every iteration agrees to
    # f32 rounding (measured max 1.5e-05), so a flipped codebook argmax or a
    # wrong prior row fails here; sigma and valid agree exactly
    np.testing.assert_allclose(est0, est0_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(packed, packed_j, rtol=0, atol=1e-3)
    for col in (6, 8):  # [pos(3), dir(3), sig, corr, valid]
        assert np.array_equal(est0[:, col], est0_j[:, col])
        assert np.array_equal(packed[..., col], packed_j[..., col])


@pytest.mark.parametrize("reuse", [1, 2])
def test_tube_trace_init_and_stage_track_jax(reuse):
    """Tube mode on the JAX tracer's own field (the port's engine, not its
    map build, is under test), with the same keys: all packed columns of
    iteration 0 and of a 7-iteration stage within 1e-3 (measured ~1e-5),
    sig and valid equal. At patch_reuse 2 the stage's reuse groups must
    match JAX's for this to hold."""
    from pnr_tpu_torch.ops.zncc_fast import field_from_numpy

    cfg = dataclasses.replace(CFG, zncc_mode="tube", patch_reuse=reuse)
    vol = tube_volume()
    sp = np.array([[10.0, 24.0, 8.0], [30.0, 24.0, 8.0], [50.0, 20.0, 5.0]], np.float32)
    sd = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0.6, 0.8, 0]], np.float32)
    keys = trace_keys(tf.key_from_seed(0), [0, 1, 2])

    jt = JaxTracker(cfg, False)
    f = jt.prepare_field(jnp.asarray(vol))
    keys_j = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(3, dtype=jnp.uint32)
    )
    carry_j, est0_j = jt._trace_init(f, jnp.asarray(sp), jnp.asarray(sd), keys_j)
    _, packed_j = jt._trace_stage(f, keys_j, carry_j, jnp.arange(1, 8), jnp.zeros(3, jnp.bool_))

    port = BatchedTracker(cfg, "cpu")
    assert port.STAGE_ITERS == jt.STAGE_ITERS == 16
    field = field_from_numpy(np.asarray(f), "cpu")
    carry, est0 = port.trace_init(field, sp, sd, keys)
    _, packed = port.trace_stage(field, keys, carry, 1, 7, torch.zeros(3, dtype=torch.bool))
    est0, packed = est0.numpy(), packed.numpy()
    est0_j, packed_j = np.asarray(est0_j), np.asarray(packed_j)

    assert packed.shape == (3, 7, 9) and packed[..., 8].any()
    np.testing.assert_allclose(est0, est0_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(packed, packed_j, rtol=0, atol=1e-3)
    for col in (6, 8):  # [pos(3), dir(3), sig, corr, valid]
        assert np.array_equal(est0[:, col], est0_j[:, col])
        assert np.array_equal(packed[..., col], packed_j[..., col])


def test_tube_field_routing_follows_jax():
    """prepare_field: bf16 when forced, float32 (monolithic) otherwise at
    this size; the true volume dims come from the packed field."""
    vol = torch.from_numpy(tube_volume())
    for dt, want in (("auto", torch.float32), ("f32", torch.float32), ("bf16", torch.bfloat16)):
        tracker = BatchedTracker(dataclasses.replace(CFG, zncc_mode="tube", tube_map_dtype=dt), "cpu")
        field = tracker.prepare_field(vol)
        assert field.dtype == want
        assert tuple(field.shape) == (2, 16, 48, 3 * 64)
        assert tracker.vol_dims(field) == (16, 48, 64)
    exact = BatchedTracker(CFG, "cpu")
    assert exact.prepare_field(vol) is vol and exact.STAGE_ITERS == 8
