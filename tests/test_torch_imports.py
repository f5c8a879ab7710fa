"""The PyTorch port imports no jax, and never runs silently on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = (
    "pnr_tpu_torch",
    "pnr_tpu_torch.__main__",
    "pnr_tpu_torch.cli",
    "pnr_tpu_torch.utils.runtime",
    "pnr_tpu_torch.ops.cuda",
    "pnr_tpu_torch.ops.gaussian",
    "pnr_tpu_torch.ops.hessian",
    "pnr_tpu_torch.ops.eig3",
    "pnr_tpu_torch.ops.frangi",
    "pnr_tpu_torch.ops.frangi_fused",
    "pnr_tpu_torch.ops.interp",
    "pnr_tpu_torch.ops.zncc",
    "pnr_tpu_torch.ops.zncc_exact",
    "pnr_tpu_torch.ops.hat_sample",
    "pnr_tpu_torch.ops.zncc_fast",
    "pnr_tpu_torch.seeds.extract",
    "pnr_tpu_torch.smc.tracker",
    "pnr_tpu_torch.graph.refine",
    "pnr_tpu_torch.pipeline",
    "pnr_tpu_torch.pipeline.reconstruct",
)


def test_port_imports_no_jax():
    # a fresh interpreter: this process already imported jax (conftest)
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot be exercised")
    from pnr_tpu.config import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruction_func

    vol = np.zeros((8, 16, 16), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reconstruction_func(vol, PNRConfig(), verbose=False, device="cuda")


def test_cuda_wrappers_reject_cpu_tensors_on_the_kernel_route():
    """The CUDA routes validate their inputs instead of falling back."""
    from pnr_tpu_torch.ops import frangi_fused, zncc_exact
    from pnr_tpu.ops.zncc_model import ZnccTemplates

    vol = torch.zeros((8, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frangi_fused._frangi3d_cuda(vol, (2.0,), 2.0, 0.5, 0.5, 500.0, False)
    tables = zncc_exact.template_tables(ZnccTemplates((2.0,), False), "cpu")
    corner = torch.zeros((1, 3), dtype=torch.int32)
    qs = torch.zeros((1, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        zncc_exact._exact_sums_cuda(vol, corner, qs, tables)


def test_tube_wrappers_reject_cpu_tensors_on_the_kernel_route():
    """K5, K6 and the map build's 1-D correlation validate their inputs on
    the CUDA route instead of falling back to the plain versions."""
    from pnr_tpu_torch.ops import gaussian, hat_sample

    patches = torch.zeros((1, 1, 4, 4, 12))
    rel = torch.zeros((1, 1, 5, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hat_sample._hat_sample_patch_cuda(patches, rel)
    maps = torch.zeros((1, 8, 8, 24))
    corners = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hat_sample._hat_sample_field_cuda(maps, corners, rel[0], (4, 4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gaussian._conv1d_cuda(torch.zeros((4, 4, 4)), np.ones(3, np.float32), 0)
    with pytest.raises(TypeError, match="uint8 or float32"):
        gaussian._conv1d_cuda(torch.zeros((4, 4, 4), dtype=torch.float64), np.ones(3), 0)
