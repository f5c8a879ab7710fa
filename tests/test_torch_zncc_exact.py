"""K2's module (pnr_tpu_torch/ops/zncc_exact.py) against the JAX package.

On the CPU the port's `ExactPatchEngine` runs the plain sums; it is held
to the JAX exact engine's XLA path (`force_xla=True`) and, at sigmas
(2, 3), to its Pallas kernel in interpret mode with the float-grade
hi/lo weights, at the bars of tests/test_hostpath.py: correlation atol
3e-4 and the argmax sigma equal on more than 97% of queries. The CUDA
kernel is held to the plain sums on the same queries in
tests/test_torch_kernels.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import STEP, ZNCC_VOLUMES, B, T, queries, zncc_tube_volume
from pnr_tpu.ops.zncc_exact import make_exact_patch_engine
from pnr_tpu.ops.zncc_model import ZnccTemplates
from pnr_tpu_torch.ops.zncc_exact import ExactPatchEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_result(vol_name, sigmas, mode):
    vol = ZNCC_VOLUMES[vol_name]()
    pos, d = queries(vol.shape)
    tmpl = ZnccTemplates(sigmas, is2d=False)
    if mode == "xla":
        eng = make_exact_patch_engine(tmpl, step=STEP, force_xla=True)
    else:
        eng = make_exact_patch_engine(tmpl, step=STEP, interpret=True, hi_lo=True)
    c, s = eng.eval_fused(jnp.asarray(vol)[None], jnp.asarray(pos), jnp.asarray(d))
    return np.asarray(c), np.asarray(s)


def port_result(vol_name, sigmas, device="cpu"):
    vol = torch.from_numpy(ZNCC_VOLUMES[vol_name]()).to(device)
    pos, d = queries(tuple(vol.shape))
    eng = ExactPatchEngine(ZnccTemplates(sigmas, is2d=False), STEP, device)
    c, s = eng.eval_fused(vol, torch.from_numpy(pos).to(device), torch.from_numpy(d).to(device))
    return c.cpu().numpy(), s.cpu().numpy()


CASES = [
    ("random", (2.0, 3.0), "xla"),
    ("random", (2.0, 3.0), "interpret"),
    ("random", (2.0, 4.0, 6.0), "xla"),
    ("tube", (2.0, 3.0), "xla"),
    ("tube", (2.0, 3.0), "interpret"),
    ("tube", (2.0, 4.0, 6.0), "xla"),
    ("flat", (2.0, 3.0), "xla"),
]


@pytest.mark.parametrize("vol_name,sigmas,mode", CASES)
def test_port_matches_jax(vol_name, sigmas, mode):
    want_c, want_s = jax_result(vol_name, sigmas, mode)
    got_c, got_s = port_result(vol_name, sigmas)
    assert got_c.shape == want_c.shape == (T, B)
    np.testing.assert_allclose(got_c, want_c, atol=3e-4)
    assert (got_s == want_s).mean() > 0.97


def test_patch_geometry_matches_jax():
    """Same patch shape and corners as the JAX engine (so both packages
    clamp stray samples the same way)."""
    vol = zncc_tube_volume()
    tmpl = ZnccTemplates((2.0, 4.0, 6.0), is2d=False)
    jeng = make_exact_patch_engine(tmpl, step=STEP, force_xla=True)
    peng = ExactPatchEngine(tmpl, STEP, "cpu")
    pos, _ = queries(vol.shape)
    centre = pos.mean(axis=1)
    patches, corner = jeng.extract(jnp.asarray(vol)[None], jnp.asarray(centre))
    got = peng.corners(vol.shape, torch.from_numpy(centre))
    assert np.array_equal(got.numpy(), np.asarray(corner))
    assert peng.dims(vol.shape) == tuple(np.asarray(patches).shape[1:])
