"""Bit-exact NumPy port of jax.random's Threefry-2x32 PRNG.

The host engine (pnr_tpu.hostpath) reproduces the device tracer's PRNG
streams WITHOUT importing jax: `fold_in`/`uniform` here return the very
same bits as `jax.random.fold_in`/`jax.random.uniform` under the
default `threefry2x32` implementation with
`jax_threefry_partitionable=True` (jax 0.9 default). Gated bitwise
against jax in tests/test_hostpath.py.

Port of jax._src.prng: `_threefry2x32_lowering` (the 20-round block
cipher), `threefry_seed`, `threefry_fold_in`,
`_threefry_random_bits_partitionable`, and jax._src.random._uniform's
mantissa-bits float construction.
"""

from __future__ import annotations

import numpy as np

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key1, key2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash on parallel uint32 count arrays.

    key1/key2 may be scalars or arrays broadcasting against x1/x2 —
    the rounds are elementwise, so a batch of keys hashes in one call
    (the vectorized per-trace stream draw of the host wave tracer)."""
    with np.errstate(over="ignore"):
        k1 = np.asarray(key1, np.uint32)
        k2 = np.asarray(key2, np.uint32)
        ks = (k1, k2, k1 ^ k2 ^ _PARITY)
        x0 = (x1 + ks[0]).astype(np.uint32)
        xo = (x2 + ks[1]).astype(np.uint32)

        def rounds(x0, x1, rots):
            for r in rots:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = _rotl(x1, r)
                x1 = x1 ^ x0
            return x0, x1

        x0, xo = rounds(x0, xo, _ROT_A)
        x0 = (x0 + ks[1]).astype(np.uint32)
        xo = (xo + ks[2] + np.uint32(1)).astype(np.uint32)

        x0, xo = rounds(x0, xo, _ROT_B)
        x0 = (x0 + ks[2]).astype(np.uint32)
        xo = (xo + ks[0] + np.uint32(2)).astype(np.uint32)

        x0, xo = rounds(x0, xo, _ROT_A)
        x0 = (x0 + ks[0]).astype(np.uint32)
        xo = (xo + ks[1] + np.uint32(3)).astype(np.uint32)

        x0, xo = rounds(x0, xo, _ROT_B)
        x0 = (x0 + ks[1]).astype(np.uint32)
        xo = (xo + ks[2] + np.uint32(4)).astype(np.uint32)

        x0, xo = rounds(x0, xo, _ROT_A)
        x0 = (x0 + ks[2]).astype(np.uint32)
        xo = (xo + ks[0] + np.uint32(5)).astype(np.uint32)
    return x0, xo


def key_from_seed(seed: int) -> np.ndarray:
    """jax.random.key(seed) raw data: uint32[2] = [seed >> 32, seed & mask]."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in: threefry_2x32(key, threefry_seed(uint32(data)))."""
    counts = np.array([0, int(data) & 0xFFFFFFFF], np.uint32)
    # threefry_2x32 on an even-length flat count splits it in half
    a, b = threefry2x32(key[0], key[1], counts[:1], counts[1:])
    return np.concatenate([a, b])


def random_bits_32(key: np.ndarray, n: int) -> np.ndarray:
    """32-bit random bits, shape (n,) — the partitionable path:
    iota_2x32 counters hashed once, halves XORed."""
    counts_lo = np.arange(n, dtype=np.uint32)
    counts_hi = np.zeros(n, np.uint32)  # n < 2**32 always holds here
    b1, b2 = threefry2x32(key[0], key[1], counts_hi, counts_lo)
    return b1 ^ b2


def uniform(key: np.ndarray, n: int) -> np.ndarray:
    """jax.random.uniform(key, (n,)) in float32 — mantissa-bit strategy."""
    bits = random_bits_32(key, n)
    float_bits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(
        np.float32(0.0), float_bits.view(np.float32) - np.float32(1.0)
    )


def fold_in_batch(keys: np.ndarray, data: int) -> np.ndarray:
    """fold_in over a (T, 2) key batch in one vectorized hash."""
    keys = np.asarray(keys, np.uint32)
    t = keys.shape[0]
    a, b = threefry2x32(
        keys[:, 0], keys[:, 1],
        np.zeros(t, np.uint32), np.full(t, int(data) & 0xFFFFFFFF, np.uint32),
    )
    return np.stack([a, b], axis=-1)


def uniforms_per_trace(keys: np.ndarray, step: int, n: int) -> np.ndarray:
    """The tracer's `_uniforms`: fold each trace key with the absolute
    iteration `step`, then draw `n` uniforms per trace, all in two
    vectorized hashes. keys: (T, 2) uint32; returns (T, n) float32
    bitwise equal to vmap(fold_in)+vmap(uniform) in jax."""
    folded = fold_in_batch(keys, step)
    t = folded.shape[0]
    counts_lo = np.broadcast_to(np.arange(n, dtype=np.uint32), (t, n))
    counts_hi = np.zeros((t, n), np.uint32)
    b1, b2 = threefry2x32(
        folded[:, 0:1], folded[:, 1:2], counts_hi, counts_lo
    )
    bits = b1 ^ b2
    float_bits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(
        np.float32(0.0), float_bits.view(np.float32) - np.float32(1.0)
    )


def stage_uniforms(keys: np.ndarray, it0: int, n_it: int, npart: int):
    """A tracer stage's draws on the host: for iterations it0 .. it0+n_it-1
    of the (T, 2) uint32 keys, the transition uniforms (n_it, T, npart) at
    step 2i and the resampling offsets (n_it, T) at step 2i+1, bitwise the
    JAX tracer's. The reference of the device draws (ops/threefry.py)."""
    keys = np.asarray(keys).astype(np.uint32)
    steps = range(it0, it0 + n_it)
    u1 = np.stack([uniforms_per_trace(keys, 2 * i, npart) for i in steps])
    ru = np.stack([uniforms_per_trace(keys, 2 * i + 1, 1)[:, 0] for i in steps])
    return u1, ru
