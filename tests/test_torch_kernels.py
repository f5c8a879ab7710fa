"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 (Frangi; also at the shapes likely to trip its plane rings: Z below
2hz + 1, dimensions of 2, odd sizes, shrunk tiles, an unaligned uint8
view), K2 (exact ZNCC sums), K3 and K4 (the unfused filter's 1-D and
fused y-x correlations; K3 at 1 to 127 taps, every axis, 4-wide and
1-wide columns, unaligned views; K4 at 13 to 127 taps, X no multiple of
4 or 16, uint8 views at odd bytes, blocks that walk several y tiles, and
slabs and tiles bitwise the whole) with the unfused and tiled Frangi
engines on them, the C side's launch plans against ops/frangi_fused.py's
and ops/conv.py's, K7's build-and-launch check, the tube map build's 1-D
correlation, `tube_corr` (the tube likelihood, K5's and K6's
counterpart), and the main paths on a small stack; and the 2-D
(one-plane) and soma routes: K2 on a one-plane patch, `tube_corr` on
one-plane windows, K3 on (1, Y, X) along y and x, the soma stage, and the
2-D and soma paths on small stacks.

Every test here needs a CUDA device (the kernels have no CPU mode): they
carry the `cuda` marker and skip without one. The file imports no jax, so
it runs on a machine with a card and no jax:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

The inputs and bars are those the plain versions are held to against the
JAX package (tests/_torch_cases.py).
"""

import itertools

import numpy as np
import pytest
import torch

from _torch_cases import (
    B,
    FRANGI_CASES,
    FRANGI_CHECKS,
    STEP,
    ZDIST,
    ZNCC_VOLUMES,
    as_numpy,
    noisy_tube,
    plane_tube,
    queries,
    queries_2d,
    tube,
    tube_queries,
)
from pnr_tpu_torch import PNRConfig
from pnr_tpu_torch.ops import conv, cuda, frangi_blocked, frangi_fused, gaussian, threefry
from pnr_tpu_torch.ops import tube_corr
from pnr_tpu_torch.ops import zncc_exact
from pnr_tpu_torch.ops.frangi import frangi3d
from pnr_tpu_torch.ops.frangi import frangi3d_plain as plain_frangi3d
from pnr_tpu_torch.ops.gaussian import gaussian_kernel
from pnr_tpu_torch.ops.zncc_exact import (
    ExactPatchEngine,
    ZnccTemplates,
    exact_corr_from_sums,
    exact_sums,
    exact_sums_plain,
)
from pnr_tpu_torch.ops.zncc_fast import (
    TubePatchEngine,
    build_tube_maps_packed,
    build_tube_maps_packed_plain,
)
from pnr_tpu_torch.ops.zncc_model import TubeZnccModel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", list(FRANGI_CASES))
def test_frangi_kernel_matches_plain(dev, case):
    make, sig = FRANGI_CASES[case]
    vol = torch.from_numpy(make()).to(dev)
    plain = as_numpy(plain_frangi3d(vol, sig, ZDIST))
    kernel = as_numpy(frangi_fused.frangi3d_fused(vol, sig, ZDIST))
    FRANGI_CHECKS[case](plain, kernel)


def test_self_check(dev):
    n = cuda.PROBE_LAUNCHES
    cuda.self_check(dev)
    assert cuda.PROBE_LAUNCHES == n + 1


def check_conv(kern, plain):
    # fused multiply-adds against rounded products: about one ulp per tap
    scale = max(float(plain.abs().max()), 1e-30)
    assert float((kern - plain).abs().max()) / scale < 1e-5


#: (taps, grad_border): sigma-6 and sigma-3 Gaussians and the Hessian's
#: first and (sigma 6) second differences
CONV_TAPS = {
    "gauss6": (gaussian_kernel(6.0), False),
    "gauss3": (gaussian_kernel(3.0), False),
    "g1": ((-0.5, 0.0, 0.5), True),
    "g2": ((-18.0, 0.0, 18.0), True),
}


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("taps", list(CONV_TAPS))
def test_conv1d_axis_kernel_matches_plain(dev, taps, dtype):
    k, grad = CONV_TAPS[taps]
    vol = torch.from_numpy(noisy_tube((20, 40, 100))).to(dev)
    if dtype == "f32":
        vol = vol.to(torch.float32) / 7.0
    for axis in (0, 1, 2):
        n = conv.CONV1D_LAUNCHES
        kern = conv.conv1d_axis(vol, k, axis, grad)
        assert conv.CONV1D_LAUNCHES == n + 1
        check_conv(kern, conv.conv1d_axis_plain(vol, k, axis, grad))


#: K4's (y taps, x taps): the unfused filter's sigmas 2, 4, 6 and 21
#: (13, 25, 37 and 127 taps) and a pair that differs
K4_TAPS = {
    "13": (gaussian_kernel(2.0),) * 2,
    "25": (gaussian_kernel(4.0),) * 2,
    "37": (gaussian_kernel(6.0),) * 2,
    "127": (gaussian_kernel(21.0),) * 2,
    "13_9": (gaussian_kernel(2.0), gaussian_kernel(1.5)),
}


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("taps", list(K4_TAPS))
@pytest.mark.parametrize("shape", [(6, 40, 136), (3, 70, 150), (2, 5, 7), (4, 19, 131)])
def test_conv_yx_kernel_matches_plain(dev, shape, taps, dtype):
    # X at 136 (a multiple of 4, not of 16), 150, 7 and 131 (neither)
    ky, kx = K4_TAPS[taps]
    vol = torch.from_numpy(noisy_tube(shape)).to(dev)
    if dtype == "f32":
        vol = vol.to(torch.float32) / 7.0
    n = conv.CONV_YX_LAUNCHES
    kern = conv.conv_yx(vol, ky, kx)
    assert conv.CONV_YX_LAUNCHES == n + 1
    check_conv(kern, conv.conv_yx_plain(vol, ky, kx))


@pytest.mark.parametrize("offset", [1, 3, 13])
def test_conv_yx_kernel_unaligned_u8_matches_plain(dev, offset):
    """A uint8 volume that starts at an odd byte: every row arrives at its
    lead within its 16-byte chunks."""
    shape = (5, 37, 150)
    base = torch.empty(int(np.prod(shape)) + offset, dtype=torch.uint8, device=dev)
    vol = base[offset:].view(shape).copy_(torch.from_numpy(noisy_tube(shape)))
    assert vol.data_ptr() % 16 != 0
    for ky, kx in (K4_TAPS["37"], K4_TAPS["13_9"]):
        kern = conv.conv_yx(vol, ky, kx)
        check_conv(kern, conv.conv_yx_plain(vol, ky, kx))
        assert torch.equal(kern, conv.conv_yx(vol.clone(), ky, kx))


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_conv_yx_kernel_tiles_are_bitwise_the_whole(dev, dtype):
    """K4 on a z slab, and on a y tile with its halo, gives the kept
    outputs bitwise as K4 on the whole volume: each output depends only on
    its coordinates, wherever the blocks fall."""
    ky = kx = K4_TAPS["37"][0]
    h = len(ky) // 2
    vol = torch.from_numpy(noisy_tube((9, 150, 140))).to(dev)
    if dtype == "f32":
        vol = vol.to(torch.float32) / 7.0
    whole = conv.conv_yx(vol, ky, kx)
    assert torch.equal(conv.conv_yx(vol[3:7].contiguous(), ky, kx), whole[3:7])
    for y0, y1 in ((0, 41), (41, 97), (97, 150)):
        lo, hi = max(y0 - h, 0), min(y1 + h, vol.shape[1])
        tile = conv.conv_yx(vol[:, lo:hi].contiguous(), ky, kx)
        assert torch.equal(tile[:, y0 - lo: y1 - lo], whole[:, y0:y1])


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_conv_yx_kernel_walks_match_plain(dev, dtype):
    """A volume whose blocks walk several y tiles around their ring of
    rows (Y and X no multiple of the tile), against the plain version and
    bitwise against its own z slabs, which walk fewer."""
    shape = (100, 450, 300)
    ky = kx = K4_TAPS["37"][0]
    assert conv.conv_yx_plan(shape, len(ky), len(kx), dtype == "u8").tiles > 1
    vol = torch.from_numpy(noisy_tube(shape)).to(dev)
    if dtype == "f32":
        vol = vol.to(torch.float32) / 7.0
    kern = conv.conv_yx(vol, ky, kx)
    check_conv(kern, conv.conv_yx_plain(vol, ky, kx))
    assert conv.conv_yx_plan((7,) + shape[1:], len(ky), len(kx), dtype == "u8").tiles == 1
    assert torch.equal(conv.conv_yx(vol[40:47].contiguous(), ky, kx), kern[40:47])


def test_conv_yx_plan_is_the_c_sides(dev):
    import ctypes

    lib = cuda.library()
    out = (ctypes.c_int * 12)()
    for shape, (nky, nkx), u8 in itertools.product(
            ((128, 640, 640), (55, 640, 640), (100, 450, 300), (2, 5, 7), (1, 1, 130),
             (65536, 1, 1)),
            ((1, 1), (13, 13), (25, 25), (37, 37), (127, 127), (37, 3), (3, 127)), (True, False)):
        assert lib.pnr_conv_yx_plan(*shape, nky, nkx, int(u8), ctypes.cast(out, ctypes.c_void_p)) == 0
        plan = conv.conv_yx_plan(shape, nky, nkx, u8)
        assert list(out) == [*plan.grid, *plan.block, plan.smem, plan.ty, plan.tx, plan.run,
                             plan.tiles, int(plan.ok)]
    assert lib.pnr_conv_yx_plan(4, 8, 8, 129, 3, 1, ctypes.cast(out, ctypes.c_void_p)) != 0


def test_conv_kernels_reject_what_they_cannot_take(dev):
    vol = torch.zeros((4, 8, 8), device=dev)
    with pytest.raises(ValueError, match="odd number of taps"):
        conv.conv1d_axis(vol, np.ones(4, np.float32), 0)
    with pytest.raises(ValueError, match="odd number of taps"):
        conv.conv_yx(vol, np.ones(129, np.float32), np.ones(3, np.float32))
    with pytest.raises(ValueError, match="axis"):
        conv.conv1d_axis(vol, np.ones(3, np.float32), 3)
    with pytest.raises(TypeError):
        conv.conv_yx(vol.to(torch.float64), np.ones(3), np.ones(3))
    with pytest.raises(ValueError, match="contiguous"):
        conv.conv1d_axis(vol.transpose(1, 2), np.ones(3, np.float32), 0)
    with pytest.raises(ValueError, match="contiguous"):
        conv.conv_yx(vol.transpose(1, 2), np.ones(3, np.float32), np.ones(3, np.float32))
    # the plan's ok flag: a grid past 65535 blocks along z
    n = conv.CONV_YX_LAUNCHES
    with pytest.raises(ValueError, match=r"\(65536, 1, 1\) volume.*65535"):
        conv.conv_yx(torch.zeros((65536, 1, 1), dtype=torch.uint8, device=dev), np.ones(3),
                     np.ones(3))
    assert conv.CONV_YX_LAUNCHES == n


@pytest.mark.parametrize("case", list(FRANGI_CASES))
def test_unfused_frangi_on_card_matches_plain(dev, case):
    make, sig = FRANGI_CASES[case]
    vol = torch.from_numpy(make()).to(dev)
    n1, n2 = conv.CONV1D_LAUNCHES, conv.CONV_YX_LAUNCHES
    card = as_numpy(frangi3d(vol, sig, ZDIST))
    assert conv.CONV1D_LAUNCHES - n1 == 10 * len(sig)
    assert conv.CONV_YX_LAUNCHES - n2 == len(sig)
    FRANGI_CHECKS[case](as_numpy(plain_frangi3d(vol, sig, ZDIST)), card)


@pytest.mark.parametrize("engine,blocks", [
    ("tiled", {"block_z": 16, "block_y": 16}),
    ("tiled", {"block_z": 16, "block_y": 24}),
    ("blocked", {"block_z": 16}),
])
def test_tiled_engines_on_card_bitwise_monolithic(dev, engine, blocks):
    vol = torch.from_numpy(noisy_tube((46, 64, 48))).to(dev)
    fn = frangi_blocked.frangi3d_tiled if engine == "tiled" else frangi_blocked.frangi3d_blocked
    got = as_numpy(fn(vol, (2.0, 3.0), ZDIST, **blocks))
    ref = as_numpy(frangi3d(vol, (2.0, 3.0), ZDIST))
    for i in (0, 3, 4, 5):
        np.testing.assert_array_equal(got[i], ref[i])
    assert float(got[1]) == float(ref[1])
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-6)


def test_frangi_kernel_blackwhite(dev):
    vol = torch.from_numpy(255 - tube((16, 32, 72))).to(dev)
    plain = as_numpy(plain_frangi3d(vol, (2.0,), ZDIST, blackwhite=True))
    kernel = as_numpy(frangi_fused.frangi3d_fused(vol, (2.0,), ZDIST, blackwhite=True))
    scale = max(float(plain[2]), 1e-12)
    assert np.abs(plain[0] - kernel[0]).max() / scale < 1e-4


def check_frangi_bars(plain, kernel):
    """chip_smoke.py's K1 bars: max|dJ|/Jmax < 1e-4, Jmin and Jmax within
    1e-4 of it, J8 within 8 with < 1% mismatch, directions aligned (median
    |cos| > 0.99 where J > 0.2 Jmax)."""
    from pnr_tpu_torch.ops.frangi import normalize_to_u8

    scale = max(float(plain[2]), 1e-12)
    assert float((kernel[0] - plain[0]).abs().max()) / scale < 1e-4
    assert abs(float(kernel[1]) - float(plain[1])) / scale < 1e-4
    assert abs(float(kernel[2]) - float(plain[2])) / scale < 1e-4
    d8 = (normalize_to_u8(*kernel[:3]).int() - normalize_to_u8(*plain[:3]).int()).abs()
    assert int(d8.max()) <= 8 and float((d8 > 0).float().mean()) < 0.01
    m = plain[0] > 0.2 * scale
    if bool(m.any()):
        dot = sum((a[m].float() / 255 * 2 - 1) * (b[m].float() / 255 * 2 - 1)
                  for a, b in zip(plain[3:], kernel[3:])).abs()
        assert float(dot.median()) > 0.99


def unaligned_u8(vol):
    """A contiguous uint8 view of `vol` whose first byte is 1 past an
    aligned address (and so not 4- or 16-byte aligned)."""
    base = torch.empty(vol.numel() + 16, dtype=torch.uint8, device=vol.device)
    off = (16 - base.data_ptr() % 16) % 16 + 1
    view = base[off:off + vol.numel()].view(vol.shape)
    view.copy_(vol)
    assert view.is_contiguous() and view.data_ptr() % 4 != 0
    return view


def tube_along(shape, axis, noise=30):
    """A bright tube along `axis` (0 z, 1 y, 2 x) through the middle of
    the other two, z scaled by ZDIST, with uniform noise: along a
    dimension of 2 the profile is flat, so the tube must run along it for
    the vesselness to be more than float32 rounding."""
    rng = np.random.default_rng(5)
    c = list(np.meshgrid(*[np.arange(s) - s / 2 for s in shape], indexing="ij"))
    c[0] = c[0] * ZDIST
    d2 = sum(c[a] ** 2 for a in range(3) if a != axis)
    v = 200.0 * np.exp(-d2 / (2 * 9.0)) + rng.integers(0, noise, shape)
    return np.clip(v, 0, 255).astype(np.uint8)


#: K1's shapes that are likely trouble: (shape, tube axis, sigmas, zdist);
#: Z below 2hz + 1, dimensions of 2, odd Y and X, a tile the rings
#: shrink, Y and X beyond one tile with edge and interior blocks
K1_TROUBLE = {
    "z_below_ring": ((6, 40, 44), 2, (2.0, 6.0), 2.0),
    "z2": ((2, 40, 44), 0, (2.0, 3.0), 2.0),
    "y2": ((12, 2, 70), 1, (2.0,), 2.0),
    "x2": ((12, 70, 2), 2, (2.0,), 2.0),
    "odd": ((10, 37, 53), 2, (2.0, 3.0), 2.0),
    "interior_blocks": ((20, 100, 140), 2, (2.0, 3.0), 2.0),
    "small_tile": ((24, 50, 70), 0, (6.0,), 0.5),
    "build_stack": ((8, 24, 24), 2, (2.0,), 2.0),
}


@pytest.mark.parametrize("case", list(K1_TROUBLE))
def test_frangi_kernel_trouble_shapes_match_plain(dev, case):
    shape, axis, sig, zdist = K1_TROUBLE[case]
    vol = torch.from_numpy(tube_along(shape, axis)).to(dev)
    n = frangi_fused.LAUNCHES
    kernel = frangi_fused.frangi3d_fused(vol, sig, zdist)
    assert frangi_fused.LAUNCHES == n + len(sig) + 1
    check_frangi_bars(plain_frangi3d(vol, sig, zdist), kernel)


def test_frangi_kernel_unaligned_view_matches_plain(dev):
    # a contiguous vol[1:] of an odd-width stack starts at an odd byte
    full = torch.from_numpy(tube((13, 33, 45), noise=30)).to(dev)
    for vol in (full[1:], unaligned_u8(full)):
        check_frangi_bars(plain_frangi3d(vol, (2.0, 3.0), ZDIST),
                          frangi_fused.frangi3d_fused(vol, (2.0, 3.0), ZDIST))


def test_frangi_kernel_is_deterministic_and_zeroes_nan(dev):
    vol = torch.from_numpy(tube((20, 70, 90), noise=40)).to(dev)
    a = frangi_fused.frangi3d_fused(vol, (2.0, 4.0), ZDIST)
    b = frangi_fused.frangi3d_fused(vol, (2.0, 4.0), ZDIST)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # a flat stack: every eigenvalue 0, the vesselness NaN, J 0
    flat = torch.full((6, 20, 24), 77, dtype=torch.uint8, device=dev)
    j, jmin, jmax, *_ = frangi_fused.frangi3d_fused(flat, (2.0,), ZDIST)
    assert not bool(j.any()) and float(jmin) == 0.0 and float(jmax) == 0.0


def test_frangi_kernel_plan_is_the_c_sides(dev):
    lib = cuda.library()
    for (ty, tx), hxy, hz in itertools.product(frangi_fused.TILES, (2, 6, 18, 63), (1, 9, 126)):
        want = frangi_fused.smem_bytes(ty, tx, hxy, hz)
        assert lib.pnr_frangi_smem_bytes(ty, tx, hxy, hz) == want


def test_frangi_kernel_rejects_what_it_cannot_take(dev):
    n = frangi_fused.LAUNCHES
    with pytest.raises(ValueError, match="at most 127 xy"):
        frangi_fused.frangi3d_fused(torch.zeros((4, 8, 8), dtype=torch.uint8, device=dev), (22.0,),
                                    ZDIST)
    with pytest.raises(ValueError, match=">= 2"):
        frangi_fused.frangi3d_fused(torch.zeros((1, 8, 8), dtype=torch.uint8, device=dev), (2.0,),
                                    ZDIST)
    with pytest.raises(TypeError):
        frangi_fused.frangi3d_fused(torch.zeros((4, 8, 8), device=dev), (2.0,), ZDIST)
    assert frangi_fused.LAUNCHES == n


#: K3's tap sets: 1, 3 (a Gaussian, and the Hessian's differences with
#: grad_border), 19, 37 and 127 taps
K3_TAPS = {
    "1": ((0.7,), False),
    "3": (gaussian_kernel(0.5), False),
    "3_g1": ((-0.5, 0.0, 0.5), True),
    "3_g2": ((-18.0, 0.0, 18.0), True),
    "19": (gaussian_kernel(3.0), False),
    "37": (gaussian_kernel(6.0), False),
    "127": (gaussian_kernel(21.0), False),
}


@pytest.mark.parametrize("layout", ["vec4", "odd", "unaligned"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("taps", list(K3_TAPS))
def test_conv1d_axis_kernel_taps_and_layouts_match_plain(dev, taps, dtype, layout):
    k, grad = K3_TAPS[taps]
    shape = (19, 30, 37) if layout == "odd" else (19, 30, 68)
    vol = torch.from_numpy(noisy_tube(shape)).to(dev)
    if dtype == "f32":
        vol = vol.to(torch.float32) / 7.0
    if layout == "unaligned":
        base = torch.empty(vol.numel() + 1, dtype=vol.dtype, device=dev)
        vol = base[1:].view(shape).copy_(vol)
        assert vol.data_ptr() % 16 != 0
    for axis in (0, 1, 2):
        n = conv.CONV1D_LAUNCHES
        kern = conv.conv1d_axis(vol, k, axis, grad)
        assert conv.CONV1D_LAUNCHES == n + 1
        check_conv(kern, conv.conv1d_axis_plain(vol, k, axis, grad))


def test_conv1d_axis_plan_is_the_c_sides(dev):
    import ctypes

    lib = cuda.library()
    out = (ctypes.c_int * 9)()
    for shape, axis, ntaps, vec4 in itertools.product(
            ((128, 640, 640), (19, 30, 37), (2, 2, 2), (9, 12, 136)), (0, 1, 2), (1, 3, 19, 127),
            (False, True)):
        lib.pnr_conv1d_plan(*shape, axis, ntaps, int(vec4), ctypes.cast(out, ctypes.c_void_p))
        plan = conv.conv1d_plan(shape, axis, ntaps, vec4)
        assert list(out) == [*plan.grid, *plan.block, plan.smem, plan.vec, int(plan.ok)]


def exact_case(dev, vol_name, b, t=None, sigmas=(2.0, 4.0, 6.0)):
    vol = torch.from_numpy(ZNCC_VOLUMES[vol_name]()).to(dev)
    pos, d = queries(tuple(vol.shape)) if t is None else queries(tuple(vol.shape), t=t)
    pos, d = torch.from_numpy(pos[:, :b]).to(dev), torch.from_numpy(d[:, :b]).to(dev)
    eng = ExactPatchEngine(ZnccTemplates(sigmas, is2d=False), STEP, dev)
    corner = eng.corners(vol.shape, pos.mean(dim=1))
    qs = eng.qinfo(vol, corner, pos, d)
    return vol, corner, qs, eng


def check_exact(eng, kern, plain):
    # the two sum ~5e3 samples in different orders: within 1e-5 of each
    # column's largest magnitude
    for i in range(3):
        scale = float(plain[..., i].abs().max())
        assert float((kern[..., i] - plain[..., i]).abs().max()) <= 1e-5 * max(scale, 1.0)
    ck, sk = exact_corr_from_sums(eng.tables, kern)
    cp, sp = exact_corr_from_sums(eng.tables, plain)
    assert float((ck - cp).abs().max()) < 3e-4
    assert float((sk == sp).float().mean()) > 0.97


@pytest.mark.parametrize("vol_name", list(ZNCC_VOLUMES))
@pytest.mark.parametrize("b", [1, B])
def test_exact_sums_kernel_matches_plain(dev, vol_name, b):
    vol, corner, qs, eng = exact_case(dev, vol_name, b)
    n = zncc_exact.LAUNCHES
    kern = exact_sums(vol, corner, qs, eng.tables, eng.dims(vol.shape))
    assert zncc_exact.LAUNCHES == n + 1
    check_exact(eng, kern, exact_sums_plain(vol, corner, qs, eng.tables, eng.dims(vol.shape)))


def slab_budget(dims, nz):
    """A slab budget that cuts a (pz, py, px) patch into `nz` slabs ("many":
    three planes a slab, more slabs than a cluster holds)."""
    pz, py, px = dims
    planes = 3 if nz == "many" else -(-(pz - 1) // nz) + 1
    return planes * py * zncc_exact.row_pitch(px)


@pytest.mark.parametrize("t", [1, 3, 128])
@pytest.mark.parametrize("b", [1, B])
@pytest.mark.parametrize("nz", [1, 2, 3, "many"])
@pytest.mark.parametrize("vol_name", list(ZNCC_VOLUMES))
def test_exact_sums_kernel_slabs_match_plain(dev, vol_name, nz, b, t):
    """The cluster kernel at 1, 2, 3 and more than 8 slabs per trace (a
    forced slab budget; a block then walks several slabs)."""
    vol, corner, qs, eng = exact_case(dev, vol_name, b, t)
    dims = eng.dims(vol.shape)
    budget = slab_budget(dims, nz)
    plan = zncc_exact.kernel_plan(dims, b, 3, budget)
    assert plan.nz > 8 if nz == "many" else plan.nz == nz
    kern = exact_sums(vol, corner, qs, eng.tables, dims, slab_budget=budget)
    check_exact(eng, kern, exact_sums_plain(vol, corner, qs, eng.tables, dims))


@pytest.mark.parametrize("nz", [1, 2, "many"])
def test_exact_sums_kernel_is_deterministic(dev, nz):
    vol, corner, qs, eng = exact_case(dev, "tube", B, 128)
    dims = eng.dims(vol.shape)
    budget = slab_budget(dims, nz)
    a = exact_sums(vol, corner, qs, eng.tables, dims, slab_budget=budget)
    b = exact_sums(vol, corner, qs, eng.tables, dims, slab_budget=budget)
    assert torch.equal(a, b)


def test_exact_sums_kernel_rejects_what_it_cannot_take(dev):
    vol, corner, qs, eng = exact_case(dev, "random", B)
    dims = eng.dims(vol.shape)
    n = zncc_exact.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        exact_sums(vol, corner.cpu(), qs, eng.tables, dims)
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        exact_sums(vol, corner, qs.cpu(), eng.tables, dims)
    with pytest.raises(TypeError):
        exact_sums(vol.to(torch.float32), corner, qs, eng.tables, dims)
    with pytest.raises(TypeError):
        exact_sums(vol, corner.long(), qs, eng.tables, dims)
    with pytest.raises(TypeError):
        exact_sums(vol, corner, qs.double(), eng.tables, dims)
    with pytest.raises(ValueError, match="bad shapes"):
        exact_sums(vol, corner[:-1].contiguous(), qs, eng.tables, dims)
    with pytest.raises(ValueError, match="contiguous"):
        exact_sums(vol.transpose(1, 2), corner, qs, eng.tables, dims)
    with pytest.raises(ValueError, match=">= 2"):
        exact_sums(vol, corner, qs, eng.tables, (dims[0], 1, dims[2]))
    with pytest.raises(ValueError, match="two planes"):
        exact_sums(vol, corner, qs, eng.tables, dims, slab_budget=100)
    assert zncc_exact.LAUNCHES == n


def small_stack():
    rng = np.random.default_rng(7)
    shape = (24, 64, 96)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 32) ** 2 + ((z - 12) * 2.0) ** 2
    return np.clip(
        200.0 * np.exp(-d2 / 18.0) * (0.7 + 0.3 * np.sin(x / 4.0)) + rng.normal(0, 5, shape),
        0, 255,
    ).astype(np.uint8)


#: the launch counters each path must raise
PATH_COUNTERS = {
    "exact": ((frangi_fused, "LAUNCHES"), (zncc_exact, "LAUNCHES")),
    "tube": ((frangi_fused, "LAUNCHES"), (gaussian, "LAUNCHES"),
             (tube_corr, "TRACE_LAUNCHES"), (tube_corr, "SCORE_LAUNCHES")),
    "unfused": ((conv, "CONV1D_LAUNCHES"), (conv, "CONV_YX_LAUNCHES"),
                (zncc_exact, "LAUNCHES")),
}


def test_main_path_on_card_matches_plain_and_launches_kernels(dev):
    _small_stack_on_card(dev, "exact")


def test_unfused_path_on_card_matches_plain_and_launches_kernels(dev):
    n = frangi_fused.LAUNCHES
    _small_stack_on_card(dev, "unfused")
    assert frangi_fused.LAUNCHES == n


def test_tube_path_on_card_matches_plain_and_launches_kernels(dev):
    _small_stack_on_card(dev, "tube")


def _small_stack_on_card(dev, mode):
    from pnr_tpu_torch.pipeline import reconstruction_func

    vol = small_stack()
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                    ni=60, np=20, zdist=2.0, nodepervol=4, vol=9,
                    zncc_mode="exact" if mode == "unfused" else mode,
                    fused_frangi=mode != "unfused")
    counters = PATH_COUNTERS[mode]
    before = [getattr(m, a) for m, a in counters]
    gpu = reconstruction_func(vol, cfg, verbose=False, device="cuda")
    assert all(getattr(m, a) > b for (m, a), b in zip(counters, before))
    cpu = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    sg = {tuple(p) for p in gpu.seeds_pos.astype(int).tolist()}
    sc = {tuple(p) for p in cpu.seeds_pos.astype(int).tolist()}
    assert len(sg & sc) >= 0.9 * max(len(sg), len(sc), 1)
    assert len(gpu.tree) > 10
    assert abs(np.median(gpu.tree.y[1:]) - 32) < 2.5
    assert abs(np.median(gpu.tree.y[1:]) - np.median(cpu.tree.y[1:])) < 2.0


# tube mode: the map build (on K3) and `tube_corr` against their
# plain versions on the card (bars of chip_smoke.py: line sums within 1e-5
# of each column's scale, corr max|d| < 1e-4, sigma agreement > 0.99)

TUBE_CASES = {
    "reuse1": ((24, 64, 96), (2.0, 3.0), 1, False),
    "reuse3_edges": ((24, 64, 96), (2.0, 3.0), 3, True),
    "sigmas_2_4_6": ((24, 64, 96), (2.0, 4.0, 6.0), 1, False),
    "degenerate": ((20, 12, 14), (2.0, 3.0), 1, False),
    # 36 (sigma, line sample) rows: more than a warp's lanes
    "four_sigmas": ((40, 64, 96), (2.0, 4.0, 6.0, 8.0), 1, False),
}


def check_samples(kern, plain):
    for c in range(3):
        scale = max(float(plain[..., c].abs().max()), 1.0)
        assert float((kern[..., c] - plain[..., c]).abs().max()) <= 1e-5 * scale


def check_corr(a, b):
    assert float((a[0] - b[0]).abs().max()) < 1e-4
    assert float((a[1] == b[1]).float().mean()) > 0.99


@pytest.mark.parametrize("sigmas", [(2.0, 3.0), (2.0, 4.0, 6.0)])
def test_map_build_kernel_matches_plain(dev, sigmas):
    vol = torch.from_numpy(noisy_tube()).to(dev)
    model = TubeZnccModel(sigmas, False)
    n, n3 = gaussian.LAUNCHES, conv.CONV1D_LAUNCHES
    kern = build_tube_maps_packed(vol, model)
    # K3's launches, counted as the map build's
    assert gaussian.LAUNCHES == n + 9 * len(sigmas) and conv.CONV1D_LAUNCHES == n3
    check_samples(kern.reshape(*kern.shape[:3], -1, 3), build_tube_maps_packed_plain(
        vol, model).reshape(*kern.shape[:3], -1, 3))


TUBE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def tube_case(dev, case, dtype):
    shape, sigmas, reuse, edges = TUBE_CASES[case]
    model = TubeZnccModel(sigmas, False)
    vol = torch.from_numpy(noisy_tube(shape)).to(dev)
    field = build_tube_maps_packed(vol, model).to(TUBE_DTYPES[dtype])
    eng = TubePatchEngine(model, STEP, ZDIST, reuse=reuse, device=dev)
    pos, d = (torch.from_numpy(a).to(dev) for a in tube_queries(shape, edges=edges))
    return shape, eng, field, pos, d


def launches():
    return tube_corr.TRACE_LAUNCHES, tube_corr.SCORE_LAUNCHES


@pytest.mark.parametrize("dtype", list(TUBE_DTYPES))
@pytest.mark.parametrize("case", list(TUBE_CASES))
def test_tube_corr_kernel_matches_plain(dev, case, dtype):
    """The tracer's evaluation: the group windows of one chunk."""
    shape, eng, field, pos, d = tube_case(dev, case, dtype)
    corners = eng.window(field, pos.mean(dim=1))
    lay = eng.layout(field)
    n5, n6 = launches()
    out, ksums = tube_corr.tube_corr(field, lay.groups, corners, pos, d, eng.tables, lay.params,
                                     with_sums=True)
    assert launches() == (n5 + 1, n6)
    kc, ks = out
    pc, ps, psums = tube_corr.tube_corr_plain(field, lay.groups, corners, pos, d, eng.tables)
    check_samples(ksums, psums)
    check_corr((kc, ks), (pc, ps))
    # the engine's route is the same launch, without the sums
    got = eng.likelihood(field, corners, pos, d)
    assert launches() == (n5 + 2, n6)
    assert torch.equal(got[0], kc) and torch.equal(got[1], ks)


@pytest.mark.parametrize("dtype", list(TUBE_DTYPES))
@pytest.mark.parametrize("case", list(TUBE_CASES))
def test_tube_corr_single_window_matches_plain(dev, case, dtype):
    """Seed scoring (B=1): one sigma_max window per query on a float32
    field, the group windows on a bfloat16 one."""
    shape, eng, field, pos, d = tube_case(dev, case, dtype)
    p1, d1 = pos[:, :1].contiguous(), d[:, :1].contiguous()
    single = dtype == "f32"
    corners = eng.window(field, p1[:, 0], single)
    lay = eng.layout(field, single)
    n5, n6 = launches()
    kc, ks = eng.eval_fused(field, p1, d1)
    assert launches() == (n5, n6 + 1)
    pc, ps, psums = tube_corr.tube_corr_plain(field, lay.groups, corners, p1, d1, eng.tables)
    check_corr((kc, ks), (pc, ps))
    _, ksums = tube_corr.tube_corr(field, lay.groups, corners, p1, d1, eng.tables, lay.params,
                                   scoring=True, with_sums=True)
    assert launches() == (n5, n6 + 2)
    check_samples(ksums, psums)
    if single:
        # the sigma_max window against the tracer's group windows
        check_corr((kc, ks), eng.likelihood(field, eng.window(field, p1[:, 0]), p1, d1))


def test_tube_corr_tie_goes_to_the_earliest_sigma(dev):
    shape = (24, 64, 96)
    vol = torch.from_numpy(noisy_tube(shape)).to(dev)
    pos, d = (torch.from_numpy(a).to(dev) for a in tube_queries(shape))
    # two sigmas with the same constants and windows, told apart by label
    model = TubeZnccModel((3.0, 3.0), False)
    eng = TubePatchEngine(model, STEP, ZDIST, device=dev)
    eng.tables = eng.tables._replace(sigmas=torch.tensor([5.0, 7.0], device=dev))
    field = build_tube_maps_packed(vol, model)
    corr, sig = eng.likelihood(field, eng.window(field, pos.mean(dim=1)), pos, d)
    assert bool((corr != 0).any()) and bool((sig == 5.0).all())
    # an all-zero field: every sigma's correlation is gated to 0
    eng = TubePatchEngine(TubeZnccModel((2.0, 4.0, 6.0), False), STEP, ZDIST, device=dev)
    zero = torch.zeros((3, *shape[:2], 3 * shape[2]), device=dev)
    corr, sig = eng.likelihood(zero, eng.window(zero, pos.mean(dim=1)), pos, d)
    assert bool((corr == 0).all()) and bool((sig == 2.0).all())


def test_tube_corr_rejects_what_it_cannot_take(dev):
    tables = TubePatchEngine(TubeZnccModel((2.0,), False), STEP, ZDIST, device=dev).tables
    pos = torch.zeros((2, 5, 3), device=dev)
    corners = torch.zeros((2, 1, 3), dtype=torch.int32, device=dev)
    field = torch.zeros((1, 8, 8, 24), device=dev)
    groups = [(0, 1, (4, 4, 4))]
    n = launches()
    with pytest.raises(ValueError, match=">= 2"):
        tube_corr.tube_corr(field, [(0, 1, (1, 4, 4))], corners, pos, pos, tables)
    with pytest.raises(TypeError):
        tube_corr.tube_corr(field.double(), groups, corners, pos, pos, tables)
    with pytest.raises(TypeError):
        tube_corr.tube_corr(field, groups, corners.float(), pos, pos, tables)
    with pytest.raises(ValueError, match="bad shapes"):
        tube_corr.tube_corr(field, groups, corners.repeat(1, 2, 1), pos, pos, tables)
    with pytest.raises(ValueError, match="bad shapes"):
        tube_corr.tube_corr(field, groups, corners, pos, pos[:, :4], tables)
    with pytest.raises(ValueError, match="bad shapes"):
        params = tube_corr.KernelParams(tables, groups, (8, 8, 7), dev)
        tube_corr.tube_corr(field, groups, corners, pos, pos, tables, params)
    with pytest.raises(ValueError, match="contiguous"):
        tube_corr.tube_corr(field, groups, corners, pos.transpose(0, 1).contiguous().transpose(0, 1),
                            pos, tables)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tube_corr.tube_corr(field, groups, corners, pos.cpu(), pos, tables)
    assert launches() == n


# the 2-D (one-plane) and soma routes


def plane_exact_case(dev, shape, b, edges=False, t=None):
    vol = torch.from_numpy(plane_tube(shape, seed=5)).to(dev)
    kw = {} if t is None else {"t": t}
    pos, d = (torch.from_numpy(a).to(dev) for a in queries_2d(shape, n=b, edges=edges, **kw))
    eng = ExactPatchEngine(ZnccTemplates((2.0, 4.0, 6.0), is2d=True), STEP, dev)
    corner = eng.corners(vol.shape, pos.mean(dim=1))
    return vol, corner, eng.qinfo(vol, corner, pos, d), eng


@pytest.mark.parametrize("py", [2, 3, 17, 64])
@pytest.mark.parametrize("px", [2, 3, 17, 64])
def test_exact_sums_kernel_one_plane_matches_plain(dev, py, px):
    """K2 on a one-plane patch (pz = 1): a plane no larger than the
    patch, so the patch is the whole plane and every query sits at its
    border; bitwise over two launches."""
    vol, corner, qs, eng = plane_exact_case(dev, (1, py, px), B, edges=True)
    dims = eng.dims(vol.shape)
    assert dims == (1, py, px)
    n = zncc_exact.LAUNCHES
    kern = exact_sums(vol, corner, qs, eng.tables, dims)
    assert zncc_exact.LAUNCHES == n + 1
    check_exact(eng, kern, exact_sums_plain(vol, corner, qs, eng.tables, dims))
    assert torch.equal(kern, exact_sums(vol, corner, qs, eng.tables, dims))


@pytest.mark.parametrize("b", [1, B])
@pytest.mark.parametrize("t", [3, 128])
def test_exact_sums_kernel_one_plane_large_matches_plain(dev, b, t):
    """Patches inside a (1, 200, 300) plane and on its borders."""
    vol, corner, qs, eng = plane_exact_case(dev, (1, 200, 300), b, edges=True, t=t)
    dims = eng.dims(vol.shape)
    assert dims[0] == 1 and zncc_exact.kernel_plan(dims, b, 3).nz == 1
    kern = exact_sums(vol, corner, qs, eng.tables, dims)
    check_exact(eng, kern, exact_sums_plain(vol, corner, qs, eng.tables, dims))
    assert torch.equal(kern, exact_sums(vol, corner, qs, eng.tables, dims))


PLANE_TUBE_CASES = {
    "plane": ((1, 64, 96), (2.0, 3.0), 1),
    "plane_reuse3": ((1, 64, 96), (2.0, 3.0), 3),
    "plane_2_4_6": ((1, 80, 120), (2.0, 4.0, 6.0), 1),
    "plane_small": ((1, 12, 14), (2.0, 3.0), 1),
}


@pytest.mark.parametrize("dtype", list(TUBE_DTYPES))
@pytest.mark.parametrize("case", list(PLANE_TUBE_CASES))
def test_tube_corr_one_plane_matches_plain(dev, case, dtype):
    """tube_corr on one-plane windows (pz = 1) of a (S, 1, Y, 3X) field,
    with clouds on the plane's corners and edges, so that the field's last
    row and column are read: the tracer's group windows and seed
    scoring's windows."""
    shape, sigmas, reuse = PLANE_TUBE_CASES[case]
    model = TubeZnccModel(sigmas, True)
    vol = torch.from_numpy(plane_tube(shape, seed=11)).to(dev)
    field = build_tube_maps_packed(vol, model).to(TUBE_DTYPES[dtype])
    eng = TubePatchEngine(model, STEP, 1.0, reuse=reuse, device=dev)
    pos, d = (torch.from_numpy(a).to(dev) for a in queries_2d(shape, t=6, n=15, edges=True))
    corners = eng.window(field, pos.mean(dim=1))
    lay = eng.layout(field)
    assert all(g[2][0] == 1 for g in lay.groups)
    # the windows reach the field's last row and last column
    hi = corners.long() + torch.tensor([g[2] for g in lay.groups], device=dev)
    assert int(hi[..., 1].max()) == shape[1] and int(hi[..., 2].max()) == shape[2]
    out, ksums = tube_corr.tube_corr(field, lay.groups, corners, pos, d, eng.tables, lay.params,
                                     with_sums=True)
    pc, ps, psums = tube_corr.tube_corr_plain(field, lay.groups, corners, pos, d, eng.tables)
    check_samples(ksums, psums)
    check_corr((out[0], out[1]), (pc, ps))
    p1, d1 = pos[:, :1].contiguous(), d[:, :1].contiguous()
    single = dtype == "f32"
    lay1 = eng.layout(field, single)
    c1 = eng.window(field, p1[:, 0], single)
    kc, ks = eng.eval_fused(field, p1, d1)
    pc1, ps1, _ = tube_corr.tube_corr_plain(field, lay1.groups, c1, p1, d1, eng.tables)
    check_corr((kc, ks), (pc1, ps1))


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("taps", [3, 13, 25, 37])
@pytest.mark.parametrize("shape", [(1, 40, 64), (1, 23, 37), (1, 2, 130)])
def test_conv1d_axis_kernel_one_plane_matches_plain(dev, shape, taps, dtype):
    """K3 on a (1, Y, X) plane along y and along x, from uint8 and float32
    (the soma and 2-D Gaussians, the 2-D map build)."""
    v = torch.from_numpy(plane_tube(shape, seed=3)).to(dev)
    if dtype == "f32":
        v = v.to(torch.float32) * 0.37
    k = gaussian_kernel((taps // 2) / 3.0)
    assert len(k) == taps
    for axis in (1, 2):
        check_conv(conv.conv1d_axis(v, k, axis), conv.conv1d_axis_plain(v, k, axis))


def test_plane_map_build_kernel_matches_plain(dev):
    vol = torch.from_numpy(plane_tube((1, 80, 120), seed=2)).to(dev)
    model = TubeZnccModel((2.0, 4.0, 6.0), True)
    n = gaussian.LAUNCHES
    kern = build_tube_maps_packed(vol, model)
    # y and x passes only: 6 launches a sigma
    assert gaussian.LAUNCHES == n + 18
    check_samples(kern.reshape(*kern.shape[:3], -1, 3), build_tube_maps_packed_plain(
        vol, model).reshape(*kern.shape[:3], -1, 3))


def test_soma_gaussian_and_stage_on_card_match_cpu(dev):
    """The soma stage's erosion and xy Gaussian (on K3) on the card against
    the CPU, and the stage's soma map, threshold and nodes."""
    from _torch_phantoms import multi_neuron_soma_phantom

    from pnr_tpu_torch.graph.nodes import NodeList
    from pnr_tpu_torch.ops.gaussian import imgaussian_xy
    from pnr_tpu_torch.ops.morphology import imerode_xy
    from pnr_tpu_torch.pipeline.reconstruct import soma_extraction

    vol, _ = multi_neuron_soma_phantom()
    v = torch.from_numpy(vol)
    n = conv.CONV1D_LAUNCHES
    g = imgaussian_xy(imerode_xy(v.to(dev), 4.0), 4.0).cpu()
    assert conv.CONV1D_LAUNCHES == n + 2
    want = imgaussian_xy(imerode_xy(v, 4.0), 4.0)
    diff = (g.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    cfg = PNRConfig(sigmas=(2.0, 3.0), somaradius=4, zdist=2.0)
    on_card, on_cpu = NodeList(), NodeList()
    smap = soma_extraction(vol, cfg, on_card, dev)
    assert np.array_equal(smap, soma_extraction(vol, cfg, on_cpu, "cpu"))
    assert len(on_card) == len(on_cpu) == 3
    for a in ("x", "y", "z", "sig", "type"):
        assert list(getattr(on_card, a)) == list(getattr(on_cpu, a))


#: the launch counters the 2-D paths must raise (the Gaussians on K3)
PLANE_PATH_COUNTERS = {
    "exact": ((conv, "CONV1D_LAUNCHES"), (zncc_exact, "LAUNCHES")),
    "tube": ((conv, "CONV1D_LAUNCHES"), (gaussian, "LAUNCHES"),
             (tube_corr, "TRACE_LAUNCHES"), (tube_corr, "SCORE_LAUNCHES")),
}


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_plane_path_on_card_matches_plain_and_launches_kernels(dev, mode):
    """The 2-D phantom through the pipeline on the card and on the CPU."""
    from _torch_phantoms import branching_neuron_phantom_2d

    from pnr_tpu_torch.pipeline import reconstruction_func

    vol, _ = branching_neuron_phantom_2d()
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=60,
                    np=16, zdist=1.0, nodepervol=4, vol=9, wave_size=32, zncc_mode=mode)
    counters = PLANE_PATH_COUNTERS[mode]
    before = [getattr(m, a) for m, a in counters]
    k1 = frangi_fused.LAUNCHES
    gpu = reconstruction_func(vol, cfg, verbose=False, device="cuda")
    assert all(getattr(m, a) > b for (m, a), b in zip(counters, before))
    assert frangi_fused.LAUNCHES == k1
    cpu = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    sg = {tuple(p) for p in gpu.seeds_pos.astype(int).tolist()}
    sc = {tuple(p) for p in cpu.seeds_pos.astype(int).tolist()}
    assert len(sg & sc) >= 0.9 * max(len(sg), len(sc), 1)
    assert len(gpu.tree) > 10 and np.allclose(gpu.tree.z[1:], 0.0, atol=1.0)
    assert abs(np.median(gpu.tree.y[1:]) - np.median(cpu.tree.y[1:])) < 2.0


def test_soma_path_on_card_matches_plain_and_launches_kernels(dev):
    """The two-soma phantom through the exact pipeline with somaradius 4,
    on the card and on the CPU: the same soma nodes and seeds."""
    from _torch_phantoms import multi_neuron_soma_phantom

    from pnr_tpu_torch.graph.nodes import SOMA
    from pnr_tpu_torch.pipeline import reconstruction_func

    vol, _ = multi_neuron_soma_phantom()
    cfg = PNRConfig(sigmas=(2.0, 3.0), somaradius=4, tolerance=10.0, znccth=0.5, kappa=2.0,
                    step=2, ni=40, np=16, zdist=2.0, nodepervol=4, vol=9, wave_size=32)
    before = (frangi_fused.LAUNCHES, zncc_exact.LAUNCHES, conv.CONV1D_LAUNCHES)
    gpu = reconstruction_func(vol, cfg, verbose=False, device="cuda")
    after = (frangi_fused.LAUNCHES, zncc_exact.LAUNCHES, conv.CONV1D_LAUNCHES)
    assert all(a > b for a, b in zip(after, before))
    cpu = reconstruction_func(vol, cfg, verbose=False, device="cpu")

    def somas(res):
        return [(res.n0.x[i], res.n0.y[i], res.n0.z[i]) for i in range(1, len(res.n0))
                if res.n0.type[i] == SOMA]

    assert somas(gpu) == somas(cpu) and len(somas(gpu)) == 2
    sg = {tuple(p) for p in gpu.seeds_pos.astype(int).tolist()}
    sc = {tuple(p) for p in cpu.seeds_pos.astype(int).tolist()}
    assert len(sg & sc) >= 0.9 * max(len(sg), len(sc), 1)


# -- several host threads: the batch driver's prefetch workers launch the
# front's kernels on their own streams while the main thread traces

#: run in a fresh interpreter, where no launch has set K2's shared memory
#: limit yet: two threads launch K2 at once, one at B=1 (seed scoring) and
#: one at B=20 (tracing), each through slab sizes that grow in turns with
#: the other's, so that every launch needs a larger limit than the last
_K2_THREADS = r"""
import threading, torch
from _torch_cases import B
from test_torch_kernels import exact_case
from pnr_tpu_torch.ops import zncc_exact
from pnr_tpu_torch.ops.zncc_exact import exact_sums

dev = torch.device("cuda")
cases = {b: exact_case(dev, "tube", b, 16) for b in (1, B)}
dims = cases[1][3].dims(cases[1][0].shape)
pitch = zncc_exact.row_pitch(dims[2])
walks = {b: [p * dims[1] * pitch for p in range(3 + k, dims[0] + 1, 2)]
         for k, b in enumerate((1, B))}
gate = threading.Barrier(2)
out, errors = {}, []

def walk(b):
    vol, corner, qs, eng = cases[b]
    gate.wait()
    for budget in walks[b]:
        try:
            out[b, budget] = exact_sums(vol, corner, qs, eng.tables, dims, slab_budget=budget)
        except Exception as e:
            errors.append(f"B={b} budget {budget}: {e}")

threads = [threading.Thread(target=walk, args=(b,)) for b in (1, B)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=120)
assert not any(t.is_alive() for t in threads), "a thread hung"
assert not errors, errors
torch.cuda.synchronize()
for (b, budget), got in out.items():
    vol, corner, qs, eng = cases[b]
    want = exact_sums(vol, corner, qs, eng.tables, dims, slab_budget=budget)
    assert torch.equal(got, want), (b, budget)
print("launches", len(out))
"""


def test_exact_sums_kernel_from_two_threads_at_once(dev):
    """K2 launched from two host threads at once with B=1 and B=20 (the
    prefetch worker's seed scoring beside the main thread's tracing): no
    launch is refused, each output is the single-threaded one. Each of
    three fresh interpreters starts with no shared memory limit set."""
    import os
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests]))
    for _ in range(3):
        proc = subprocess.run([sys.executable, "-c", _K2_THREADS], cwd=tests, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert int(proc.stdout.split()[-1]) > 10


def test_launch_counters_are_exact_under_two_threads(dev):
    """Two threads launch K7 and K2 many times with a short switch
    interval: the counters count every launch."""
    import sys
    import threading

    vol, corner, qs, eng = exact_case(dev, "tube", 1, 4)
    dims = eng.dims(vol.shape)
    x = torch.ones((8, 128), device=dev)
    n = 300
    before = (cuda.PROBE_LAUNCHES, zncc_exact.LAUNCHES)

    def work():
        for _ in range(n):
            cuda.probe(x)
            exact_sums(vol, corner, qs, eng.tables, dims)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert (cuda.PROBE_LAUNCHES - before[0], zncc_exact.LAUNCHES - before[1]) == (4 * n, 4 * n)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_batch_on_card_prefetch_is_bitwise_prefetch_off(dev, mode):
    """Two stacks through `reconstruction_batch` on the card, prefetched
    on worker streams and one by one: bitwise the same trees, seeds and
    trace counts, and the same kernel launches."""
    from pnr_tpu_torch.pipeline import reconstruction_batch

    vols = [small_stack(), small_stack()[:, ::-1].copy()]
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                    ni=60, np=20, zdist=2.0, nodepervol=4, vol=9, zncc_mode=mode)
    counters = PATH_COUNTERS[mode]
    runs = []
    for prefetch in (True, False):
        before = [getattr(m, a) for m, a in counters]
        res = list(reconstruction_batch(vols, cfg, prefetch=prefetch, device="cuda"))
        runs.append((res, [getattr(m, a) - b for (m, a), b in zip(counters, before)]))
    (on, n_on), (off, n_off) = runs
    assert n_on == n_off and all(k > 0 for k in n_on)
    for a, b in zip(on, off):
        assert a.trace_count == b.trace_count > 0
        np.testing.assert_array_equal(a.seeds_pos, b.seeds_pos)
        np.testing.assert_array_equal(a.seeds_corr, b.seeds_corr)
        for f in ("x", "y", "z", "sig", "corr"):
            np.testing.assert_array_equal(np.asarray(getattr(a.tree, f)),
                                          np.asarray(getattr(b.tree, f)))
            np.testing.assert_array_equal(np.asarray(getattr(a.n0, f)),
                                          np.asarray(getattr(b.n0, f)))


# -- the sharded path: slab frames, the virtual mesh -----------------------


def slab_case(dev, mode, shape=(64, 64, 96), z0=10, z1=54):
    """A field and a slab of it (planes [z0, z1)) with its frame, an engine,
    and queries around the tube axis at z ~ 32 (inside the slab)."""
    from pnr_tpu_torch.ops.slab import SlabFrame
    from pnr_tpu_torch.ops.zncc_model import ZnccTemplates

    vol = torch.from_numpy(noisy_tube(shape)).to(dev)
    rng = np.random.default_rng(4)
    pos = np.stack([rng.uniform(20, 76, (16, B)), rng.normal(32, 1.5, (16, B)),
                    rng.normal(32, 1.0, (16, B))], -1).astype(np.float32)
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (16, B, 1))
    pos, d = (torch.from_numpy(a).to(dev) for a in (pos, d))
    frame = SlabFrame((z0, 0, 0), shape)
    if mode == "tube":
        model = TubeZnccModel((2.0, 3.0), False)
        field = build_tube_maps_packed(vol, model)
        eng = TubePatchEngine(model, STEP, ZDIST, device=dev)
        return eng, field, field[:, z0:z1].contiguous(), frame, pos, d
    eng = ExactPatchEngine(ZnccTemplates((2.0, 3.0), False), STEP, dev)
    return eng, vol, vol[z0:z1].contiguous(), frame, pos, d


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_engines_read_a_slab_as_the_whole_field(dev, mode):
    """Under a slab frame K2 and tube_corr compute, for windows inside the
    slab, bitwise what they compute on the whole field; tube_corr's slab
    origin agrees with its plain version."""
    eng, field, slab, frame, pos, d = slab_case(dev, mode)
    whole = eng.eval_fused(field, pos, d)
    part = eng.eval_fused(slab, pos, d, frame)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])
    if mode == "tube":
        corners = eng.window(slab, pos.mean(dim=1), frame=frame)
        assert torch.equal(corners, eng.window(field, pos.mean(dim=1)))
        got = eng.likelihood(slab, corners, pos, d, frame=frame)
        assert torch.equal(got[0], eng.likelihood(field, corners, pos, d)[0])
        lay = eng.layout(slab, frame=frame)
        pc, ps, _ = tube_corr.tube_corr_plain(slab.cpu(), lay.groups, corners.cpu(), pos.cpu(),
                                              d.cpu(), eng.tables._replace(**{
                                                  k: v.cpu() for k, v in
                                                  eng.tables._asdict().items()}), frame)
        check_corr(got, (pc.to(dev), ps.to(dev)))


def test_sharded_filter_on_a_virtual_mesh_bitwise_monolithic(dev):
    """frangi3d_sharded on four shards of cuda:0 (K4 and K3 on each
    aligned halo slab) is bitwise the monolithic frangi3d on the card."""
    from pnr_tpu_torch.parallel import Mesh, frangi3d_sharded, shard_volume

    mesh = Mesh((torch.device("cuda", 0),) * 4)
    for case, (make, sig) in FRANGI_CASES.items():
        vol = make()
        want = frangi3d(torch.from_numpy(vol).to(dev), sig, ZDIST)
        n3, n4 = conv.CONV1D_LAUNCHES, conv.CONV_YX_LAUNCHES
        j, jmin, jmax, vx, vy, vz = frangi3d_sharded(shard_volume(vol, mesh), sig, ZDIST, mesh)
        assert conv.CONV1D_LAUNCHES > n3 and conv.CONV_YX_LAUNCHES > n4
        for a, b in zip((j, vx, vy, vz), (want[0], want[3], want[4], want[5])):
            assert torch.equal(torch.cat(a), b), case
        assert torch.equal(jmin, want[1]) and torch.equal(jmax, want[2]), case


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_sharded_path_on_a_virtual_mesh_matches_single_device(dev, mode):
    """reconstruction_func_sharded on four shards of cuda:0 against the
    single-device path on the card with the same (unfused) filter: J8 and
    seeds equal, SWC F1 >= 0.85, traces handed off and none lost."""
    import tempfile

    from pnr_tpu_torch.io.swc import read_swc, save_nodelist
    from pnr_tpu_torch.parallel import Mesh
    from pnr_tpu_torch.pipeline import reconstruction_func, reconstruction_func_sharded
    from pnr_tpu_torch.utils.swc_compare import compare_swc

    vol = small_stack()
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                    ni=60, np=20, zdist=2.0, nodepervol=4, vol=9, zncc_mode=mode,
                    fused_frangi=False)
    mesh = Mesh((torch.device("cuda", 0),) * 4)
    got = reconstruction_func_sharded(vol, cfg, mesh, verbose=False)
    ref = reconstruction_func(vol, cfg, verbose=False, device="cuda")
    np.testing.assert_array_equal(got.j8, ref.j8)
    np.testing.assert_array_equal(got.seeds_pos, ref.seeds_pos)
    assert got.n_handoffs > 0 and got.n_lost == 0
    pa, pb = tempfile.mktemp(suffix=".swc"), tempfile.mktemp(suffix=".swc")
    save_nodelist(got.tree, pa)
    save_nodelist(ref.tree, pb)
    assert compare_swc(read_swc(pa), read_swc(pb), dist=3.0, resample=1.0).f1 >= 0.85


# -- batches over a mesh: one stack a shard, groups of shards sharing the card ---------


def _two_stacks():
    """small_stack and its y mirror (a tube at y = 31 instead of 32)."""
    a = small_stack()
    return [a, np.ascontiguousarray(a[:, ::-1])]


def _assert_same_run(a, b):
    np.testing.assert_array_equal(a.j8, b.j8)
    assert a.trace_count == b.trace_count and len(a.n0) == len(b.n0) > 1
    np.testing.assert_allclose(a.n0.positions(), b.n0.positions(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_batch_dp_on_a_virtual_mesh_matches_the_batch(dev, mode):
    """reconstruction_batch_dp, one stack a shard of cuda:0, against
    reconstruction_batch with fused_frangi=False on the card, at JAX's bar
    (tests/test_parallel.py:743); the batch's filter launches K4 and K3 and
    never K1."""
    from pnr_tpu_torch.parallel import Mesh, reconstruction_batch_dp
    from pnr_tpu_torch.pipeline import reconstruction_batch

    vols = _two_stacks()
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2, ni=40,
                    np=20, zdist=2.0, nodepervol=4, vol=9, zncc_mode=mode, fused_frangi=False)
    n1, n4 = frangi_fused.LAUNCHES, conv.CONV_YX_LAUNCHES
    got = reconstruction_batch_dp(vols, cfg, Mesh((torch.device("cuda", 0),) * 2))
    assert frangi_fused.LAUNCHES == n1 and conv.CONV_YX_LAUNCHES > n4
    for a, b in zip(got, reconstruction_batch(vols, cfg, prefetch=False, device="cuda")):
        _assert_same_run(a, b)


def test_batch_sharded_groups_sharing_the_card_match_one_by_one(dev):
    """reconstruction_batch_sharded: two groups of two shards of cuda:0, each
    on its own host thread and stream, against reconstruction_func_sharded
    one stack at a time on a two-shard mesh (tests/test_parallel.py:927)."""
    from pnr_tpu_torch.parallel import Mesh, reconstruction_batch_sharded
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    vols = _two_stacks()
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2, ni=40,
                    np=20, zdist=2.0, nodepervol=4, vol=9)
    got = reconstruction_batch_sharded(vols, cfg, Mesh((torch.device("cuda", 0),) * 4), groups=2)
    sub = Mesh((torch.device("cuda", 0),) * 2)
    for v, a in zip(vols, got):
        _assert_same_run(a, reconstruction_func_sharded(v, cfg, sub, verbose=False))


# -- the device seed flood, the one-shot wave, the alternate extractor, the sharded seeds ---


def test_device_flood_on_card_bitwise_cpu(dev, monkeypatch):
    """max_points_device on the card is bitwise its CPU run (the same torch
    ops; the centroid sums in int64, the fma of the distances in float64),
    whole and in chunks of 4 planes, and within JAX's bound of the native
    flood."""
    from pnr_tpu_torch import native
    from pnr_tpu_torch.seeds import extract
    from pnr_tpu_torch.seeds.extract import max_points_device

    rng = np.random.default_rng(0)
    j8 = (rng.integers(0, 5, (6, 96, 128)) * 50).astype(np.uint8)
    smooth = np.clip(small_stack()[:, :, :].astype(np.int32) + 20, 0, 255).astype(np.uint8)
    for vol, tol in ((j8, 10.0), (smooth, 10.0), (smooth, 0.0)):
        cpu = max_points_device(torch.from_numpy(vol), tol)
        card = max_points_device(torch.from_numpy(vol).to(dev), tol)
        assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)
        with monkeypatch.context() as m:
            m.setattr(extract, "FLOOD_BUDGET_BYTES", 4 * extract.FLOOD_BYTES_PER_VOXEL * vol[0].size)
            assert torch.equal(max_points_device(torch.from_numpy(vol).to(dev), tol).cpu(), cpu)
        assert int(cpu.sum()) == int(native.max_finder_stack(vol, tol).sum())


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_trace_wave_on_card_staged_bitwise_unstaged(dev, mode):
    """BatchedTracker.trace_wave on the card: staged bitwise unstaged, and
    K2 (exact) or tube_corr (tube) launched."""
    from pnr_tpu_torch.hostpath import threefry as tf
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    cfg = PNRConfig(sigmas=(2.0, 3.0), znccth=0.3, kappa=3.0, step=2, ni=24, np=20, zdist=2.0,
                    nodepervol=4, vol=9, zncc_mode=mode)
    tracker = BatchedTracker(cfg, dev, stage_iters=5)
    field = tracker.prepare_field(torch.from_numpy(small_stack()).to(dev))
    rng = np.random.default_rng(2)
    n = 150  # two chunks of TRACE_CHUNK
    sp = np.stack([rng.uniform(10, 86, n), rng.normal(32, 2, n), rng.normal(12, 1, n)], -1).astype(np.float32)
    sd = np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1))
    sd[::2, 0] = -1.0
    k2, tc = zncc_exact.LAUNCHES, tube_corr.TRACE_LAUNCHES
    a = tracker.trace_wave(field, sp, sd, tf.key_from_seed(4), np.arange(n))
    assert (zncc_exact.LAUNCHES > k2) if mode == "exact" else (tube_corr.TRACE_LAUNCHES > tc)
    b = tracker.trace_wave(field, sp, sd, tf.key_from_seed(4), np.arange(n), staged=False)
    assert a.valid.sum() > n
    for name in ("pos", "dir", "sig", "corr", "valid"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_frangi3d_with_scale_launches_k4_and_k3(dev):
    """frangi3d_with_scale runs the unfused per-scale filter on the card:
    one K4 and four K3 launches a scale, J bitwise frangi3d's."""
    from pnr_tpu_torch.seeds.alt import frangi3d_with_scale

    vol = torch.from_numpy(small_stack()).to(dev)
    sig = (2.0, 3.0)
    n3, n4 = conv.CONV1D_LAUNCHES, conv.CONV_YX_LAUNCHES
    j, vx, vy, vz, sc = frangi3d_with_scale(vol, sig, ZDIST)
    assert conv.CONV_YX_LAUNCHES - n4 == len(sig)
    assert conv.CONV1D_LAUNCHES - n3 == 10 * len(sig)
    assert torch.equal(j, frangi3d(vol, sig, ZDIST)[0]) and sc.dtype == torch.uint8
    assert int(sc.max()) == len(sig) - 1


def test_seeds_sharded_on_a_virtual_mesh(dev):
    """seeds_sharded on four shards of cuda:0: each shard's seeds are the
    strongest of the card flood of its planes, ties in voxel order, and
    the card run's positions, validity and counts are bitwise the CPU
    mesh's and its directions within 1e-6 (torch divides by 255 through
    the reciprocal on a card)."""
    from pnr_tpu_torch.ops.frangi import normalize_to_u8
    from pnr_tpu_torch.parallel import Mesh, make_mesh, seeds_sharded, shard_volume
    from pnr_tpu_torch.seeds.extract import max_points_device

    j, jmin, jmax, vx, vy, vz = frangi3d(torch.from_numpy(small_stack()).to(dev), (2.0, 3.0), ZDIST)
    maps = [a.cpu().numpy() for a in (normalize_to_u8(j, jmin, jmax), vx, vy, vz)]
    cap = 5
    got = seeds_sharded(*[shard_volume(a, Mesh((dev,) * 4)) for a in maps], 10.0,
                        Mesh((dev,) * 4), cap)
    cpu = make_mesh(4, device="cpu")
    want = seeds_sharded(*[shard_volume(a, cpu) for a in maps], 10.0, cpu, cap)
    for i in (0, 2, 3):
        assert np.array_equal(got[i], want[i]), i
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    mask = max_points_device(torch.from_numpy(maps[0]).to(dev), 10.0).cpu().numpy()
    zl = maps[0].shape[0] // 4
    for s in range(4):
        zz, yy, xx = np.nonzero(mask[s * zl:(s + 1) * zl])
        score = maps[0][s * zl:(s + 1) * zl][zz, yy, xx].astype(int)
        top = np.lexsort((np.arange(len(score)), -score))[:cap]
        assert np.array_equal(got[0][s * cap:s * cap + len(top)],
                              np.stack([xx[top], yy[top], zz[top] + s * zl], -1).astype(np.float32))
        assert got[3][s] == len(zz)


# -- the tracer's Threefry draws (csrc/threefry.cu) --------------------------


def _draw_keys(t, dev):
    from pnr_tpu_torch.hostpath import threefry as tf
    from pnr_tpu_torch.smc.tracker import trace_keys

    # ids up to past 2**31, as a wave's 2 * seed index + 1 may be
    return threefry.key_tensor(trace_keys(tf.key_from_seed(11), np.arange(t) * 977 + 2**31 - 40),
                               dev)


@pytest.mark.parametrize("t,n_it", [(128, 8), (128, 16), (1, 8)])
def test_threefry_kernel_bitwise_plain(dev, t, n_it):
    """The draws' kernel against its plain version on the same card
    tensors at the tracer stage's shapes (T = 128 at 8 and 16 iterations,
    np 20) and at T = 1, at it0 1, 97 and 2**30 + 3 (steps past 2**31):
    bitwise, one launch a call; and `trace_init`'s draw (it0 0, one
    iteration, one draw: steps 0 and 1)."""
    keys = _draw_keys(t, dev)
    for it0, n, npart in ((1, n_it, 20), (97, n_it, 20), (2**30 + 3, n_it, 20), (0, 1, 1)):
        it = torch.tensor(it0, dtype=torch.int32, device=dev)
        n0 = threefry.LAUNCHES
        u1, ru = threefry.stage_draws(keys, it, n, npart)
        assert threefry.LAUNCHES == n0 + 1
        pu1, pru = threefry.stage_draws_plain(keys, it, n, npart)
        assert u1.shape == (n, t, npart) and ru.shape == (n, t)
        assert torch.equal(u1, pu1) and torch.equal(ru, pru), it0
        assert float(u1.min()) >= 0.0 and float(u1.max()) < 1.0


def test_threefry_kernel_refuses_what_it_cannot_draw(dev):
    """A CUDA tensor reaches the kernel or raises: int64 keys, (T, 3) keys
    or an it0 on another device are refused, with no launch."""
    keys = _draw_keys(4, dev)
    it = torch.ones((), dtype=torch.int32, device=dev)
    n0 = threefry.LAUNCHES
    for bad_keys, bad_it in ((keys.to(torch.int64), it), (torch.zeros((4, 3), dtype=torch.int32,
                                                                      device=dev), it),
                             (keys, it.cpu())):
        with pytest.raises((TypeError, ValueError)):
            threefry.stage_draws(bad_keys, bad_it, 2, 3)
    assert threefry.LAUNCHES == n0


def test_threefry_in_a_captured_graph_draws_each_replays_it0(dev):
    """The capture trap: a CUDA graph of one stage's draws (T = 128, 16
    iterations, np 20), replayed with its static `it0` set to 17, 33 and 1,
    gives at each replay the plain draws of that it0 (the kernel reads
    `it0` from device memory; by value it would repeat the captured one)."""
    keys = _draw_keys(128, dev)
    it0 = torch.ones((), dtype=torch.int32, device=dev)
    threefry.stage_draws(keys, it0, 16, 20)  # the library loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        u1, ru = threefry.stage_draws(keys, it0, 16, 20)
    seen = []
    for v in (17, 33, 1):
        it0.fill_(v)
        graph.replay()
        pu1, pru = threefry.stage_draws_plain(keys, it0, 16, 20)
        assert torch.equal(u1, pu1) and torch.equal(ru, pru), v
        seen.append(u1.clone())
    assert not torch.equal(seen[0], seen[1])


# -- the tracer's stage graphs (smc/graphs.py) -----------------------------


def _graph_cfg(mode):
    return PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                     ni=60, np=20, zdist=2.0, nodepervol=4, vol=9, zncc_mode=mode)


def _trace_counts():
    return (zncc_exact.LAUNCHES, tube_corr.TRACE_LAUNCHES, tube_corr.SCORE_LAUNCHES,
            threefry.LAUNCHES)


def _drive_waves(tracker, waves, use_graphs):
    """Each (field, n traces) wave as the wave loop runs it: `trace_init`
    per TRACE_CHUNK slot, then every stage at STAGE_ITERS iterations,
    eagerly (`trace_stage`) or through the tracker's stage-graph runner of
    the field, with a kill mask that retires every third trace from the
    third stage on; the keys on the card. Returns per wave the packed
    estimates of every stage and the final carries, on the host."""
    from pnr_tpu_torch.hostpath import threefry as tf
    from pnr_tpu_torch.smc.tracker import trace_keys

    out = []
    for w, (field, n) in enumerate(waves):
        rng = np.random.default_rng(w)
        sp = np.stack([rng.uniform(10, 86, n), rng.normal(32, 2, n), rng.normal(12, 1, n)],
                      -1).astype(np.float32)
        sd = np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1))
        sd[::2, 0] = -1.0
        keys = threefry.key_tensor(trace_keys(tf.key_from_seed(5), np.arange(n) + 1000 * w),
                                   field.device)
        slices = [slice(b, min(b + tracker.TRACE_CHUNK, n))
                  for b in range(0, n, tracker.TRACE_CHUNK)]
        runner = tracker.stage_graphs(field) if use_graphs else None
        assert (runner is not None) == use_graphs
        if runner is not None:
            runner.join_warm()
        carries, packs = [], []
        for c, slc in enumerate(slices):
            carry, _ = tracker.trace_init(field, sp[slc], sd[slc], keys[slc])
            carries.append(carry)
            if runner is not None:
                runner.load(c, carry, keys[slc])
        ni, stage = tracker.cfg.ni, tracker.STAGE_ITERS
        for k, it0 in enumerate(range(1, ni, stage)):
            for c, slc in enumerate(slices):
                killed = np.zeros(slc.stop - slc.start, bool)
                if k >= 2:
                    killed[::3] = True
                if runner is not None:
                    packs.append(runner.stage(c, it0, killed).numpy())
                    continue
                carries[c], packed = tracker.trace_stage(
                    field, keys[slc], carries[c], it0, stage,
                    torch.from_numpy(killed).to(field.device))
                packs.append(packed.cpu().numpy())
        if runner is not None:
            runner.finish()
            carries = [runner.slots[(c, slc.stop - slc.start)].carry
                       for c, slc in enumerate(slices)]
        out.append((packs, [[t.cpu().numpy() for t in carry] for carry in carries]))
    return out


def _same_waves(eager, graph):
    for (pa, ca), (pb, cb) in zip(eager, graph):
        assert len(pa) == len(pb)
        for a, b in zip(pa, pb):
            assert np.array_equal(a, b)
        for a, b in zip(ca, cb):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_stage_graphs_bitwise_eager_stages(dev, mode):
    """The stage-graph runner against the eager stages: two waves on one
    field (256 traces in two slots, then 90 reusing slot 0 at a new T) and
    a wave on a second field, with a kill mask: bitwise equal packed
    estimates and carries, equal launch counts, and the routes of
    `StagePlan` (a key captured at its first stage, replayed after; the
    second field has a runner of its own, which captures anew)."""
    from pnr_tpu_torch.smc import graphs
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    cfg = _graph_cfg(mode)
    vols = [small_stack(), small_stack()[:, ::-1].copy()]
    runs = {}
    for use in (False, True):
        tracker = BatchedTracker(cfg, dev, graphs=use)
        fields = [tracker.prepare_field(torch.from_numpy(v).to(dev)) for v in vols]
        before = _trace_counts()
        caps, reps = graphs.CAPTURES, graphs.REPLAYS
        result = _drive_waves(tracker, [(fields[0], 256), (fields[0], 90), (fields[1], 128)], use)
        torch.cuda.synchronize()
        runs[use] = (result, [a - b for a, b in zip(_trace_counts(), before)],
                     graphs.CAPTURES - caps, graphs.REPLAYS - reps)
        if use:
            # the second field's runner, one slot of T=128: captured at its
            # first stage, replayed at every later one
            stages = -(-(cfg.ni - 1) // tracker.STAGE_ITERS)
            assert stages >= 3
            assert tracker.stage_graphs(fields[1]).routes == {"capture": 1,
                                                               "replay": stages - 1}
            assert tracker.stage_graphs(fields[0]).routes["capture"] == 3
    (eager, n_eager, c0, r0), (graph, n_graph, caps, reps) = runs[False], runs[True]
    assert (c0, r0) == (0, 0)
    # keys (slot, T, n_it) captured: (0, 128, S), (1, 128, S), (0, 90, S), then (0, 128, S)
    # on the second field
    assert caps == 4 and reps > caps
    assert n_graph == n_eager and n_eager[1 if mode == "tube" else 0] > 0
    _same_waves(eager, graph)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_warm_thread_graphs_replay_bitwise_eager_stages(dev, mode):
    """`warm_async` captures the two slots of a full wave on its thread
    (positions ones, keys fold_in(key(0), i)); a wave of 256 traces then
    replays those graphs at every stage, capturing none on the tracing
    thread, and gives bitwise the eager stages' estimates and carries. The
    warm thread's `trace_init` launches are real and counted: two on the
    tracer's counter and one draw."""
    from pnr_tpu_torch.smc import graphs
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    cfg = _graph_cfg(mode)
    vol = torch.from_numpy(small_stack()).to(dev)
    eager_tracker = BatchedTracker(cfg, dev, graphs=False)
    before = _trace_counts()
    eager = _drive_waves(eager_tracker, [(eager_tracker.prepare_field(vol), 256)], False)
    n_eager = [a - b for a, b in zip(_trace_counts(), before)]

    tracker = BatchedTracker(cfg, dev)
    field = tracker.prepare_field(vol)
    before = _trace_counts()
    caps = graphs.CAPTURES
    th = tracker.warm_async(field)
    assert th is not None
    th.join()
    runner = tracker.stage_graphs(field)
    runner.join_warm()
    assert runner.warm_captures == 2 and graphs.CAPTURES - caps == 2 and runner.warm_s > 0
    graph = _drive_waves(tracker, [(field, 256)], True)
    torch.cuda.synchronize()
    n_graph = [a - b for a, b in zip(_trace_counts(), before)]
    assert runner.routes == {"capture": 0, "replay": 2 * -(-(cfg.ni - 1) // tracker.STAGE_ITERS)}
    tracer = 1 if mode == "tube" else 0
    n_eager[tracer] += 2
    n_eager[3] += 1
    assert n_graph == n_eager
    _same_waves(eager, graph)
    tracker.drop_stage_graphs(field)
    assert tracker.graph_log[-1]["warm_captures"] == 2


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_main_path_graphs_bitwise_eager(dev, mode, monkeypatch):
    """reconstruction_func on the card with stage graphs (the default),
    with the warm thread and without it (PNR_TPU_NO_WARM_ASYNC=1), against
    `BatchedTracker(..., graphs=False)`: bitwise the same tree, n0 and trace
    count, graph replays in the graph runs, the same launches (the draws'
    included) but the warm thread's `trace_init` (two on the tracer's
    counter, one draw), and with the warm thread no capture on the tracing
    thread."""
    from pnr_tpu_torch.pipeline import reconstruction_func
    from pnr_tpu_torch.smc import graphs
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    cfg = _graph_cfg(mode)
    vol = small_stack()
    counters = PATH_COUNTERS[mode] + ((threefry, "LAUNCHES"),)
    runs = []
    for use, warm in ((True, True), (True, False), (False, False)):
        if warm:
            monkeypatch.delenv("PNR_TPU_NO_WARM_ASYNC", raising=False)
        else:
            monkeypatch.setenv("PNR_TPU_NO_WARM_ASYNC", "1")
        before = [getattr(m, a) for m, a in counters]
        reps = graphs.REPLAYS
        tracker = BatchedTracker(cfg, dev, graphs=use)
        res = reconstruction_func(vol, cfg, verbose=False, device="cuda", _tracker=tracker)
        runs.append((res, [getattr(m, a) - b for (m, a), b in zip(counters, before)],
                     graphs.REPLAYS - reps, tracker.graph_log[-1] if use else None))
    (g, n_g, reps_g, log_g), (c, n_c, reps_c, log_c), (e, n_e, reps_e, _) = runs
    assert reps_g > 0 and reps_c > 0 and reps_e == 0
    assert log_g["warm_captures"] == 2 and log_g["routes"]["capture"] == 0
    assert log_c["warm_captures"] == 0 and log_c["routes"]["capture"] > 0
    tracer = 2 if mode == "tube" else 1
    assert n_c == n_e and n_e[-1] > 0
    want = list(n_e)
    want[tracer] += 2
    want[-1] += 1
    assert n_g == want
    for r in (g, c):
        assert r.trace_count == e.trace_count > 0
        for f in ("x", "y", "z", "sig", "corr"):
            assert np.array_equal(np.asarray(getattr(r.tree, f)), np.asarray(getattr(e.tree, f)))
            assert np.array_equal(np.asarray(getattr(r.n0, f)), np.asarray(getattr(e.n0, f)))


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_batch_graphs_prefetch_bitwise_eager_one_by_one(dev, mode):
    """Two stacks through `reconstruction_batch` with prefetch on (each
    stack's graphs captured by its warm thread while a worker runs its
    front on its own stream, the second while the first replays) against
    the stacks one by one with eager stages (stack i keyed fold_in(key, i),
    as the batch keys it): bitwise the same trees and n0, the same
    launches but the warm threads' `trace_init` (two a stack on the
    tracer's counter, one draw), and no capture on the tracing thread. The
    caller synchronises the whole device at each result."""
    from pnr_tpu_torch.hostpath import threefry as tf
    from pnr_tpu_torch.pipeline import reconstruct, reconstruction_batch, reconstruction_func
    from pnr_tpu_torch.smc import graphs
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    vols = [small_stack(), small_stack()[:, ::-1].copy()]
    cfg = _graph_cfg(mode)
    counters = PATH_COUNTERS[mode] + ((threefry, "LAUNCHES"),)
    made = []
    real = reconstruct.BatchedTracker

    def keep(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    reconstruct.BatchedTracker = keep
    try:
        before = [getattr(m, a) for m, a in counters]
        caps = graphs.CAPTURES
        batch = []
        for res in reconstruction_batch(vols, cfg, prefetch=True, device="cuda"):
            # a caller may synchronise the whole device between results: no
            # warm thread captures meanwhile (graphs.CaptureGate)
            torch.cuda.synchronize()
            batch.append(res)
        n_batch = [getattr(m, a) - b for (m, a), b in zip(counters, before)]
    finally:
        reconstruct.BatchedTracker = real
    assert graphs.CAPTURES - caps == 4  # two slots a stack, on the warm threads
    (tracker,) = made
    assert [log["routes"]["capture"] for log in tracker.graph_log] == [0, 0]
    assert [log["warm_captures"] for log in tracker.graph_log] == [2, 2]
    before = [getattr(m, a) for m, a in counters]
    key = tf.key_from_seed(cfg.seed)
    eager = [reconstruction_func(v, cfg, verbose=False, key=tf.fold_in(key, i), device="cuda",
                                 _tracker=BatchedTracker(cfg, dev, graphs=False))
             for i, v in enumerate(vols)]
    n_eager = [getattr(m, a) - b for (m, a), b in zip(counters, before)]
    n_eager[2 if mode == "tube" else 1] += 2 * len(vols)
    n_eager[-1] += len(vols)
    assert n_batch == n_eager
    for a, b in zip(batch, eager):
        assert a.trace_count == b.trace_count > 0
        for f in ("x", "y", "z", "sig", "corr"):
            assert np.array_equal(np.asarray(getattr(a.tree, f)), np.asarray(getattr(b.tree, f)))
            assert np.array_equal(np.asarray(getattr(a.n0, f)), np.asarray(getattr(b.n0, f)))


# -- the mesh tracers' stage graphs: batch DP's waves, the handoff shards ---------


def _mesh_route(monkeypatch, use_graphs):
    """The mesh tracers' trackers on a route: stage graphs (the default) or
    eager stages (`BatchedTracker(..., graphs=False)`), with every stage's
    packed estimates recorded on the host in dispatch order (an eager
    `trace_stage`'s, or a replayed stage's, fetched as it is dispatched:
    the sharded loop drops a stage in flight when its wave ends)."""
    import functools

    from pnr_tpu_torch.parallel import batch_dp, handoff
    from pnr_tpu_torch.smc import graphs
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    packs = []
    if use_graphs:
        stage = graphs.StageGraphs.stage

        def replayed(self, *a, **k):
            pending = stage(self, *a, **k)
            packs.append(pending.numpy())
            return pending

        monkeypatch.setattr(graphs.StageGraphs, "stage", replayed)
    else:
        for mod in (batch_dp, handoff):
            monkeypatch.setattr(mod, "BatchedTracker",
                                functools.partial(BatchedTracker, graphs=False))
        stage = BatchedTracker.trace_stage

        def trace_stage(self, *a, **k):
            carry, packed = stage(self, *a, **k)
            packs.append(packed.cpu().numpy())
            return carry, packed

        monkeypatch.setattr(BatchedTracker, "trace_stage", trace_stage)
    return packs


def _mesh_graphs_vs_eager(monkeypatch, mode, run):
    """`run()` on the eager route, then on the graph route: each stage's
    packed estimates, the trees, node graphs and trace counts bitwise, the
    tracer's launches (likelihood and draws) equal, and the graph route's
    captures and replays. Returns (eager result, graph result, captures)."""
    from pnr_tpu_torch.smc import graphs

    counters = ((zncc_exact, "LAUNCHES"), (tube_corr, "TRACE_LAUNCHES"),
                (tube_corr, "SCORE_LAUNCHES"), (threefry, "LAUNCHES"))
    runs = []
    for use in (False, True):
        with monkeypatch.context() as m:
            packs = _mesh_route(m, use)
            before = [getattr(mod, a) for mod, a in counters]
            caps, reps = graphs.CAPTURES, graphs.REPLAYS
            res = run()
            torch.cuda.synchronize()
            runs.append((res, packs, [getattr(mod, a) - b for (mod, a), b in zip(counters, before)],
                         graphs.CAPTURES - caps, graphs.REPLAYS - reps))
    (eager, p_e, n_e, c_e, r_e), (got, p_g, n_g, c_g, r_g) = runs
    assert (c_e, r_e) == (0, 0) and c_g > 0 and r_g > c_g
    assert n_g == n_e and n_e[1 if mode == "tube" else 0] > 0 and n_e[3] > 0
    assert len(p_g) == len(p_e) == r_g and all(np.array_equal(a, b) for a, b in zip(p_e, p_g))
    for a, b in zip(eager if isinstance(eager, list) else [eager],
                    got if isinstance(got, list) else [got]):
        assert a.trace_count == b.trace_count > 0
        for na, nb in ((a.tree, b.tree), (a.n0, b.n0)):
            assert len(na) == len(nb) > 1
            for f in ("x", "y", "z", "sig", "corr", "type"):
                assert np.array_equal(np.asarray(getattr(na, f)), np.asarray(getattr(nb, f)))
    return eager, got, c_g


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_mesh_graphs_batch_dp_bitwise_eager(dev, mode, monkeypatch):
    """reconstruction_batch_dp, two stacks on a two-shard virtual mesh of
    the card, its lockstep waves replayed as stage graphs against the same
    waves with eager stages: bitwise (each stage's estimates, trees, node
    graphs, trace counts), the same launches, one capture a stack (one key:
    2 * wave_size lanes at STAGE_ITERS) and no warm thread."""
    from pnr_tpu_torch.parallel import Mesh, reconstruction_batch_dp

    vols = _two_stacks()
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2, ni=40,
                    np=20, zdist=2.0, nodepervol=4, vol=9, zncc_mode=mode, fused_frangi=False,
                    wave_size=64)
    mesh = Mesh((torch.device("cuda", 0),) * 2)
    _, _, caps = _mesh_graphs_vs_eager(
        monkeypatch, mode, lambda: reconstruction_batch_dp(vols, cfg, mesh))
    assert caps == 2


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_mesh_graphs_sharded_bitwise_eager(dev, mode, monkeypatch):
    """reconstruction_func_sharded on a four-shard virtual mesh of the card,
    each shard's stages replayed as stage graphs under its slab's frame,
    against the same run with eager stages: bitwise (each stage's
    estimates, tree, node graph, trace count, handoffs), the same launches,
    at most one capture a shard, traces handed off and none lost."""
    from pnr_tpu_torch.parallel import Mesh
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    vol = small_stack()
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                    ni=60, np=20, zdist=2.0, nodepervol=4, vol=9, zncc_mode=mode,
                    fused_frangi=False)
    mesh = Mesh((torch.device("cuda", 0),) * 4)
    eager, got, caps = _mesh_graphs_vs_eager(
        monkeypatch, mode, lambda: reconstruction_func_sharded(vol, cfg, mesh, verbose=False))
    assert 2 <= caps <= 4
    assert got.n_handoffs == eager.n_handoffs > 0 and got.n_lost == 0


def test_exact_sums_kernel_nan_queries_match_plain(dev):
    """A dead lane's NaN query (a zero seed direction, as JAX's one-shot
    pads its lanes): K2 floors its sample coordinates at 0 with `fmaxf`,
    and so does the plain version; the other traces' sums are bitwise
    those without the NaN trace."""
    vol, corner, qs, eng = exact_case(dev, "tube", B)
    bad = qs.clone()
    bad[0, :, [1, 2, 4, 5, 7, 8, 9, 10]] = float("nan")  # the first trace's frame axes
    dims = eng.dims(vol.shape)
    want = exact_sums(vol, corner, qs, eng.tables, dims)
    got = exact_sums(vol, corner, bad, eng.tables, dims)
    assert torch.equal(got[1:], want[1:]) and torch.isfinite(got).all()
    check_exact(eng, got, exact_sums_plain(vol, corner, bad, eng.tables, dims))
