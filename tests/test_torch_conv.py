"""K3 and K4's module (pnr_tpu_torch/ops/conv.py) against the JAX package.

On the CPU `conv1d_axis` and `conv_yx` run their plain versions; they are
held to the Pallas kernels `_pallas_conv` and `_pallas_conv_yx` in
interpret mode, on the inputs of tests/test_ops_dense.py's interpret-mode
tests, within 1e-6 of the largest magnitude (equality is expected: both
round each product and each add in tap order). The CUDA kernels are held
to the plain versions in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from pnr_tpu.ops.gaussian import gaussian_kernel
from pnr_tpu.ops.pallas_conv import _pallas_conv, _pallas_conv_yx
from pnr_tpu_torch.ops import conv, gaussian, hessian


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G1 = (-0.5, 0.0, 0.5)
G2 = (-0.5 * 9.0, 0.0, 0.5 * 9.0)  # sigma 3's second-difference taps


def assert_close(got, want):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= 1e-6 * np.abs(want).max()


def u8_volume(shape):
    return (np.random.default_rng(42).random(shape) * 255).astype(np.uint8)


def f32_volume(shape):
    return np.random.default_rng(42).random(shape).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_conv1d_axis_plain_matches_pallas(axis):
    vol = u8_volume((6, 40, 136))
    k = gaussian_kernel(2.0)
    want = _pallas_conv(vol, tuple(float(t) for t in k), axis, False, interpret=True)
    assert_close(conv.conv1d_axis_plain(torch.from_numpy(vol), k, axis).numpy(), want)


@pytest.mark.parametrize("taps", [G1, G2, (0.5, 0.0, -0.5)], ids=["g1", "g2", "neg"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_conv1d_axis_plain_grad_border_matches_pallas(axis, taps):
    vol = f32_volume((6, 24, 136))
    want = _pallas_conv(vol, taps, axis, True, interpret=True)
    got = conv.conv1d_axis_plain(torch.from_numpy(vol), taps, axis, grad_border=True).numpy()
    assert_close(got, want)
    if taps == G1:
        # the central-difference taps with doubled end planes are
        # jnp.gradient (hessian.gradient), bit for bit
        np.testing.assert_array_equal(got, hessian.gradient(torch.from_numpy(vol), axis).numpy())


def test_conv_yx_plain_matches_pallas():
    vol = u8_volume((4, 48, 136))
    ky, kx = gaussian_kernel(2.0), gaussian_kernel(1.5)
    want = _pallas_conv_yx(
        vol, tuple(float(t) for t in ky), tuple(float(t) for t in kx), interpret=True
    )
    assert_close(conv.conv_yx_plain(torch.from_numpy(vol), ky, kx).numpy(), want)


def test_cpu_tensors_take_the_plain_versions():
    vol = torch.from_numpy(u8_volume((5, 20, 30)))
    k = gaussian_kernel(1.5)
    n1, n2 = conv.CONV1D_LAUNCHES, conv.CONV_YX_LAUNCHES
    assert torch.equal(conv.conv1d_axis(vol, G1, 1, True), conv.conv1d_axis_plain(vol, G1, 1, True))
    assert torch.equal(conv.conv_yx(vol, k, k), conv.conv_yx_plain(vol, k, k))
    # the CPU routes of the unfused filter's passes are the plain chains
    assert torch.equal(gaussian.imgaussian3d(vol, 2.0, 2.0),
                       gaussian.imgaussian3d_plain(vol, 2.0, 2.0))
    for a, b in zip(hessian.hessian3d(vol, 2.0, 2.0), hessian.hessian3d_plain(vol, 2.0, 2.0)):
        assert torch.equal(a, b)
    assert (conv.CONV1D_LAUNCHES, conv.CONV_YX_LAUNCHES) == (n1, n2)
