"""The tracer's device draws (pnr_tpu_torch/ops/threefry.py) on the CPU,
where `stage_draws` runs its plain version: bitwise the JAX tracer's
`_uniforms` (`vmap(fold_in(k, step))` then `vmap(uniform(k, shape))` on
keys fold_in(key(seed), id)) and bitwise `hostpath/threefry`; and the
port's `trace_init` and `trace_stage`, drawing through that route, against
JAX's at the same keys. The kernel itself needs a card:
tests/test_torch_kernels.py (`-k threefry`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnr_tpu.smc.tracker import BatchedTracker as JaxTracker
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.ops import threefry
from pnr_tpu_torch.smc.tracker import BatchedTracker, trace_keys
from test_torch_tracker import CFG, tube_volume

MASK = 0xFFFFFFFF
NI = 100  # the main path's iterations: the last stage's steps reach 2 * NI - 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_keys(seed, ids):
    """The JAX tracer's trace keys fold_in(key(seed), id) and their raw
    (T, 2) uint32 data."""
    base = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.asarray(ids, jnp.uint32))
    return keys, np.asarray(jax.random.key_data(keys))


def jax_uniforms(keys, step, shape):
    """The JAX tracer's `_uniforms` (pnr_tpu/smc/tracker.py:327-329)."""
    ks = jax.vmap(lambda k: jax.random.fold_in(k, jnp.uint32(step & MASK)))(keys)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(ks))


def trace_ids(t):
    """t trace ids from 0 up to 2**31 + 5 (a wave's ids are 2 * seed index
    and 2 * seed index + 1)."""
    return np.unique(np.linspace(0, 2**31 + 5, t).astype(np.int64)) if t > 1 else np.array([7])


@pytest.mark.parametrize("t", [1, 7, 128])
@pytest.mark.parametrize("n", [1, 20, 33])
def test_plain_draw_is_jax_uniforms_bitwise(t, n):
    """At steps 0, 1, 2 * NI - 1 and one past 2**31 (masked to 32 bits, as
    the tracer's int32 step 2i wraps): the plain draw is bitwise the JAX
    tracer's `_uniforms` and `hostpath/threefry.uniforms_per_trace`."""
    ids = trace_ids(t)
    assert len(ids) == t and ids.max() <= 2**31 + 5
    keys_j, raw = jax_keys(3, ids)
    keys = threefry.key_tensor(raw, "cpu")
    assert np.array_equal(keys.numpy().view(np.uint32), trace_keys(tf.key_from_seed(3), ids))
    steps = [0, 1, 2 * NI - 1, 2**31 + 11]
    got = threefry.uniforms_plain(keys, torch.tensor(steps, dtype=torch.int64), n).numpy()
    assert got.shape == (len(steps), t, n) and got.dtype == np.float32
    for s, step in enumerate(steps):
        assert np.array_equal(got[s], jax_uniforms(keys_j, step, (n,))), step
        assert np.array_equal(got[s], tf.uniforms_per_trace(raw, step & MASK, n)), step


@pytest.mark.parametrize("t,n_it", [(128, 8), (128, 16), (1, 8)])
@pytest.mark.parametrize("it0", [1, 97, 2**30 + 3])
def test_stage_draws_are_host_stage_uniforms_bitwise(t, n_it, it0):
    """A stage's draws through the wrapper on CPU tensors (the plain
    version, no launch counted), at the tracer stage's shapes (np 20) and
    at an it0 whose steps pass 2**31: bitwise the host reference, which
    draws them with hostpath/threefry.py."""
    raw = trace_keys(tf.key_from_seed(11), trace_ids(t))
    launches = threefry.LAUNCHES
    u1, ru = threefry.stage_draws(threefry.key_tensor(raw, "cpu"),
                                  torch.tensor(it0, dtype=torch.int32), n_it, CFG.np)
    assert threefry.LAUNCHES == launches
    want_u1, want_ru = tf.stage_uniforms(raw, it0, n_it, CFG.np)
    assert u1.shape == (n_it, t, CFG.np) and ru.shape == (n_it, t)
    assert np.array_equal(u1.numpy(), want_u1) and np.array_equal(ru.numpy(), want_ru)


def test_key_tensor_takes_the_uint32_bits():
    """Keys on the device are int32 tensors of the keys' uint32 bits: a
    NumPy array (uint32 or int64) is copied into one; an int32 tensor is
    taken as it is; another dtype is refused."""
    raw = trace_keys(tf.key_from_seed(2), [0, 2**31 + 5])
    assert raw.max() >= 2**31  # a key with the top bit set
    k = threefry.key_tensor(raw, "cpu")
    assert k.dtype == torch.int32 and k.shape == (2, 2)
    assert np.array_equal(k.numpy().view(np.uint32), raw)
    assert torch.equal(threefry.key_tensor(raw.astype(np.int64), "cpu"), k)
    assert threefry.key_tensor(k, "cpu") is k
    with pytest.raises(TypeError, match="int32"):
        threefry.key_tensor(k.to(torch.int64), "cpu")


def jax_trace(cfg, vol, sp, sd, ids, n_it):
    jt = JaxTracker(cfg, False)
    f = jt.prepare_field(jnp.asarray(vol)) if cfg.zncc_mode == "tube" else jnp.asarray(vol)[None]
    keys_j, raw = jax_keys(0, ids)
    carry0, est0 = jt._trace_init(f, jnp.asarray(sp), jnp.asarray(sd), keys_j)
    carry, packed = jt._trace_stage(f, keys_j, carry0, jnp.arange(1, 1 + n_it),
                                    jnp.zeros(len(ids), jnp.bool_))
    host = [[np.asarray(c) for c in cs] for cs in (carry0, carry)]
    return f, raw, host, np.asarray(est0), np.asarray(packed)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_trace_init_and_stage_drawing_on_the_device_route_track_jax(mode):
    """`trace_init` and a 7-iteration `trace_stage` with the keys as an
    int32 tensor on the tracer's device (the route a card takes; the plain
    draw on the CPU), against JAX's `trace_init` and `trace_stage` at the
    same keys: every part of the carries that the draws decide (particle
    positions and directions, the resampled flags, the resampling indices,
    alive) bitwise; the weights within 1e-4 and the packed estimates within
    tests/test_torch_tracker.py's 1e-3, sigma and valid bitwise. The keys
    as a uint32 NumPy array give bitwise the same."""
    from pnr_tpu_torch.ops.zncc_fast import field_from_numpy

    cfg = dataclasses.replace(CFG, zncc_mode=mode)
    vol = tube_volume()
    sp = np.array([[10.0, 24.0, 8.0], [30.0, 24.0, 8.0], [50.0, 20.0, 5.0]], np.float32)
    sd = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0.6, 0.8, 0]], np.float32)
    ids = np.array([0, 1, 2**31 + 5])
    f, raw, carries_j, est0_j, packed_j = jax_trace(cfg, vol, sp, sd, ids, 7)
    field = field_from_numpy(np.asarray(f), "cpu") if mode == "tube" else torch.from_numpy(vol)

    port = BatchedTracker(cfg, "cpu")
    runs = []
    for keys in (threefry.key_tensor(raw, "cpu"), raw):
        carry, est0 = port.trace_init(field, sp, sd, keys)
        init_carry = [c.numpy() for c in carry]
        carry, packed = port.trace_stage(field, keys, carry, 1, 7, torch.zeros(3, dtype=torch.bool))
        runs.append((init_carry, [c.numpy() for c in carry], est0.numpy(), packed.numpy()))
    for a, b in zip(runs[0], runs[1]):
        for x, y in zip(a, b) if isinstance(a, list) else ((a, b),):
            assert np.array_equal(x, y)

    init_carry, carry, est0, packed = runs[0]
    for got, want in zip((init_carry, carry), carries_j):
        for i in (0, 1, 3, 4, 5):  # pos, dirs, resampled, res_idx, alive
            assert np.array_equal(got[i], want[i].astype(got[i].dtype)), i
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)
    assert packed.shape == (3, 7, 9) and packed[..., 8].any()
    np.testing.assert_allclose(est0, est0_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(packed, packed_j, rtol=0, atol=1e-3)
    for col in (6, 8):  # [pos(3), dir(3), sig, corr, valid]
        assert np.array_equal(est0[:, col], est0_j[:, col])
        assert np.array_equal(packed[..., col], packed_j[..., col])
