"""The tracer's Threefry-2x32 uniforms on the device: `stage_draws`, a
hand-written CUDA kernel (csrc/threefry.cu), and its plain PyTorch version.

Port of the JAX tracer's `_uniforms` (pnr_tpu/smc/tracker.py:327-329),
which draws inside the jitted stage: for each trace key, `fold_in(key,
step)` then `uniform(key, (n,))` under jax_threefry_partitionable. The
stage's draws for iterations it0 .. it0 + n_it - 1 are the transition
uniforms `u1` (n_it, T, np) at step 2i and the resampling offsets `ru`
(n_it, T) at step 2i + 1, bitwise `hostpath/threefry.uniforms_per_trace`.

Keys live on the device as (T, 2) int32 tensors holding the uint32 bits
of each trace's key (`key_tensor`); `it0` is an int32 scalar tensor on the
same device, read by the kernel from device memory, so that a stage
captured in a CUDA graph draws the iteration its static `it0` buffer
holds at each replay.

* `stage_draws_plain` is the plain version, in int64 tensors masked to 32
  bits (torch's uint32 has few operations).
* `stage_draws` sends CPU tensors to the plain version and CUDA tensors
  to the kernel, or raises; each kernel launch adds one to `LAUNCHES`.
"""

from __future__ import annotations

import numpy as np
import torch

from pnr_tpu_torch.ops import cuda

#: `pnr_threefry_uniforms` kernel launches (one a tracer stage and one a
#: `trace_init`)
LAUNCHES = 0

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def key_tensor(keys, device) -> torch.Tensor:
    """(T, 2) trace keys as a contiguous int32 tensor of their uint32 bits
    on `device`: a tensor on that device is taken as it is (it must be
    int32); a NumPy array (any integer type) is copied there once."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype != torch.int32:
            raise TypeError(f"keys must be int32 (the uint32 bits), got {keys.dtype}")
        return keys.to(device).contiguous()
    bits = np.ascontiguousarray(np.asarray(keys).astype(np.uint32)).view(np.int32)
    return torch.from_numpy(bits).to(device)


# -- the plain version ------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32_plain(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under the keys
    (k0, k1): int64 tensors holding uint32 values, broadcasting."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for n, rots in enumerate((_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)):
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(n + 1) % 3]) & _MASK
        x1 = (x1 + ks[(n + 2) % 3] + n + 1) & _MASK
    return x0, x1


def uniforms_plain(keys: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """The tracer's `_uniforms` at each step of `steps` (S,) int64: for
    every trace key of `keys` (T, 2) int32, fold_in(key, step) then n
    uniforms. Returns (S, T, n) float32, bitwise jax.random's."""
    k = keys.to(torch.int64) & _MASK
    step = (steps.to(torch.int64) & _MASK)[:, None]  # (S, 1)
    f0, f1 = threefry2x32_plain(k[None, :, 0], k[None, :, 1], torch.zeros_like(step), step)
    c = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32_plain(f0[..., None], f1[..., None], torch.zeros_like(c), c)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return torch.clamp(bits.to(torch.int32).view(torch.float32) - 1.0, min=0.0)


def stage_draws_plain(keys: torch.Tensor, it0: torch.Tensor, n_it: int, npart: int):
    """The plain version of `stage_draws`: (u1 (n_it, T, npart), ru (n_it, T))."""
    i = it0.to(torch.int64) + torch.arange(n_it, dtype=torch.int64, device=keys.device)
    return uniforms_plain(keys, 2 * i, npart), uniforms_plain(keys, 2 * i + 1, 1)[..., 0]


# -- the kernel ------------------------------------------------------------


def stage_draws(keys: torch.Tensor, it0: torch.Tensor, n_it: int, npart: int):
    """The uniforms of iterations it0 .. it0 + n_it - 1 for the trace keys
    `keys` (T, 2) int32 (`key_tensor`), `it0` an int32 scalar tensor on the
    same device: (u1 (n_it, T, npart), ru (n_it, T)) float32. CPU tensors
    run the plain version; CUDA tensors launch `pnr_threefry_uniforms`
    once, or raise."""
    if keys.device.type == "cpu":
        return stage_draws_plain(keys, it0, n_it, npart)
    return _stage_draws_cuda(keys, it0, n_it, npart)


def _stage_draws_cuda(keys, it0, n_it, npart):
    global LAUNCHES
    dev = keys.get_device()
    if (dev < 0 or keys.dtype is not torch.int32 or keys.dim() != 2 or keys.shape[1] != 2
            or not keys.is_contiguous()):
        cuda.require_cuda_tensor(keys, "keys", torch.int32, 2)
        raise ValueError(f"keys must be (T, 2), got {tuple(keys.shape)}")
    if it0.dtype is not torch.int32 or it0.numel() != 1 or it0.get_device() != dev:
        raise ValueError(f"it0 must be one int32 on {keys.device}, got {it0.dtype} "
                         f"{tuple(it0.shape)} on {it0.device}")
    t = int(keys.shape[0])
    u1 = torch.empty((n_it, t, npart), dtype=torch.float32, device=keys.device)
    ru = torch.empty((n_it, t), dtype=torch.float32, device=keys.device)
    err = cuda.library().pnr_threefry_uniforms(
        keys.data_ptr(), it0.data_ptr(), t, int(n_it), int(npart), u1.data_ptr(), ru.data_ptr(),
        cuda.raw_stream(dev))
    if err:
        cuda.check(err, "pnr_threefry_uniforms")
    with cuda.COUNT_LOCK:
        LAUNCHES += 1
    return u1, ru
