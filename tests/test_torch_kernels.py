"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (the kernels have no CPU mode): they
carry the `cuda` marker and skip without one. The file imports no jax, so
it runs on a machine with a card and no jax:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

The inputs and bars are those the plain versions are held to against the
JAX package (tests/_torch_cases.py).
"""

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
    queries,
    tube,
)
from pnr_tpu_torch import PNRConfig
from pnr_tpu_torch.ops import frangi_fused, zncc_exact
from pnr_tpu_torch.ops.frangi import frangi3d as plain_frangi3d
from pnr_tpu_torch.ops.zncc_exact import (
    ExactPatchEngine,
    ZnccTemplates,
    exact_corr_from_sums,
    exact_sums,
    exact_sums_plain,
)

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


def test_frangi_kernel_blackwhite(dev):
    vol = torch.from_numpy(255 - tube((16, 32, 72))).to(dev)
    plain = as_numpy(plain_frangi3d(vol, (2.0,), ZDIST, blackwhite=True))
    kernel = as_numpy(frangi_fused.frangi3d_fused(vol, (2.0,), ZDIST, blackwhite=True))
    scale = max(float(plain[2]), 1e-12)
    assert np.abs(plain[0] - kernel[0]).max() / scale < 1e-4


@pytest.mark.parametrize("vol_name", list(ZNCC_VOLUMES))
@pytest.mark.parametrize("b", [1, B])
def test_exact_sums_kernel_matches_plain(dev, vol_name, b):
    vol = torch.from_numpy(ZNCC_VOLUMES[vol_name]()).to(dev)
    pos, d = queries(tuple(vol.shape))
    pos, d = torch.from_numpy(pos[:, :b]).to(dev), torch.from_numpy(d[:, :b]).to(dev)
    eng = ExactPatchEngine(ZnccTemplates((2.0, 4.0, 6.0), is2d=False), STEP, dev)
    corner = eng.corners(vol.shape, pos.mean(dim=1))
    qs = eng.qinfo(vol, corner, pos, d)
    kern = exact_sums(vol, corner, qs, eng.tables, eng.dims(vol.shape))
    plain = exact_sums_plain(vol, corner, qs, eng.tables, eng.dims(vol.shape))
    # the two sum ~5e3 samples in different orders: within 1e-5 of each
    # column's largest magnitude
    for i in range(3):
        scale = float(plain[..., i].abs().max())
        assert float((kern[..., i] - plain[..., i]).abs().max()) <= 1e-5 * max(scale, 1.0)
    ck, sk = exact_corr_from_sums(eng.tables, kern)
    cp, sp = exact_corr_from_sums(eng.tables, plain)
    assert float((ck - cp).abs().max()) < 3e-4
    assert float((sk == sp).float().mean()) > 0.97


def test_main_path_on_card_matches_plain_and_launches_kernels(dev):
    from pnr_tpu_torch.pipeline import reconstruction_func

    rng = np.random.default_rng(7)
    shape = (24, 64, 96)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 32) ** 2 + ((z - 12) * 2.0) ** 2
    vol = np.clip(
        200.0 * np.exp(-d2 / 18.0) * (0.7 + 0.3 * np.sin(x / 4.0)) + rng.normal(0, 5, shape),
        0, 255,
    ).astype(np.uint8)
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                    ni=60, np=20, zdist=2.0, nodepervol=4, vol=9)
    k1, k2 = frangi_fused.LAUNCHES, zncc_exact.LAUNCHES
    gpu = reconstruction_func(vol, cfg, verbose=False, device="cuda")
    assert frangi_fused.LAUNCHES > k1 and zncc_exact.LAUNCHES > k2
    cpu = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    sg = {tuple(p) for p in gpu.seeds_pos.astype(int).tolist()}
    sc = {tuple(p) for p in cpu.seeds_pos.astype(int).tolist()}
    assert len(sg & sc) >= 0.9 * max(len(sg), len(sc), 1)
    assert len(gpu.tree) > 10
    assert abs(np.median(gpu.tree.y[1:]) - 32) < 2.5
    assert abs(np.median(gpu.tree.y[1:]) - np.median(cpu.tree.y[1:])) < 2.0
