"""K1's module (pnr_tpu_torch/ops/frangi_fused.py) against the JAX package.

On the CPU the port's `frangi3d_fused` runs its plain PyTorch chain; it is
held to the JAX fused kernel in interpret mode and to the XLA `frangi3d`
at the bars of tests/test_frangi_fused.py and tests/test_hostpath.py
(tests/_torch_cases.py). The CUDA kernel is held to the plain chain on
the same cases in tests/test_torch_kernels.py.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_cases import FRANGI_CASES, FRANGI_CHECKS, ZDIST, as_numpy, tube
from pnr_tpu.ops.frangi import frangi3d as jax_frangi3d
from pnr_tpu.ops.frangi import normalize_to_u8 as jax_normalize
from pnr_tpu.ops.frangi_fused import _frangi3d_fused_impl
from pnr_tpu_torch.ops.frangi import normalize_to_u8
from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def reference(case, engine):
    """JAX outputs as numpy: the fused kernel in interpret mode, or XLA."""
    make, sig = FRANGI_CASES[case]
    vol = make()
    if engine == "fused_interpret":
        out = _frangi3d_fused_impl(vol, sig, ZDIST, 0.5, 0.5, 500.0, False, 8, 16, True)
    else:
        out = jax_frangi3d(vol, sig, ZDIST)
    return tuple(np.asarray(a) for a in out)


# the hostpath bars are defined against the XLA frangi3d only
PAIRS = [
    (case, engine)
    for case in FRANGI_CASES
    for engine in ("fused_interpret", "xla")
    if not (case == "hostpath" and engine == "fused_interpret")
]


@pytest.mark.parametrize("case,engine", PAIRS)
def test_port_matches_jax(case, engine):
    make, sig = FRANGI_CASES[case]
    got = as_numpy(frangi3d_fused(torch.from_numpy(make()), sig, ZDIST))
    FRANGI_CHECKS[case](reference(case, engine), got)


def test_blackwhite_matches_xla():
    vol = 255 - tube((16, 32, 72))  # dark ridge on a bright background
    ref = [np.asarray(a) for a in jax_frangi3d(vol, (2.0,), ZDIST, blackwhite=True)]
    got = as_numpy(frangi3d_fused(torch.from_numpy(vol), (2.0,), ZDIST, blackwhite=True))
    scale = max(float(ref[2]), 1e-12)
    assert np.abs(ref[0] - got[0]).max() / scale < 1e-4


def test_normalize_matches_jax():
    rng = np.random.default_rng(0)
    j = rng.random((4, 8, 8)).astype(np.float32)
    want = np.asarray(jax_normalize(j, j.min(), j.max()))
    got = normalize_to_u8(torch.from_numpy(j), torch.tensor(j.min()), torch.tensor(j.max()))
    assert np.array_equal(got.numpy(), want)
    flat = np.full((2, 3, 3), 0.25, np.float32)
    got = normalize_to_u8(torch.from_numpy(flat), torch.tensor(0.25), torch.tensor(0.25))
    assert not got.numpy().any()
