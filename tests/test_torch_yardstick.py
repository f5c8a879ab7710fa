"""The port's quality yardstick against the JAX package's, on the CPU.

The jax-free phantom copies (tests/_torch_phantoms.py) must be bitwise
the originals in tests/test_phantom_neuron.py; the port's `compare_swc`
(pnr_tpu_torch/utils/swc_compare.py) must give the JAX package's
numbers; `python -m pnr_tpu_torch.compare` must run and print them.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_phantoms as port_phantoms
import test_phantom_neuron as jax_phantoms
from pnr_tpu.utils.swc_compare import compare_swc as jax_compare_swc
from pnr_tpu_torch.io.swc import read_swc
from pnr_tpu_torch.utils.swc_compare import compare_swc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHANTOMS = {
    "branching": ("branching_neuron_phantom", {}),
    "branching_seed7": ("branching_neuron_phantom", {"shape": (16, 80, 112), "seed": 7}),
    "crossing": ("crossing_tubes_phantom", {}),
    "branching_2d": ("branching_neuron_phantom_2d", {}),
    "multi_neuron_soma": ("multi_neuron_soma_phantom", {}),
    "snr_15": ("snr_phantom", {"noise_sigma": 15}),
    "snr_40_flat": ("snr_phantom", {"noise_sigma": 40, "bg_gradient": False, "psf": False}),
}


@pytest.mark.parametrize("case", sorted(PHANTOMS))
def test_phantom_copies_are_bitwise_the_originals(case):
    name, kw = PHANTOMS[case]
    want = getattr(jax_phantoms, name)(**kw)
    got = getattr(port_phantoms, name)(**kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
        else:
            assert a == b


def _gold():
    return port_phantoms.branching_neuron_phantom()[1]


def _perturbed(gold, sd, seed=0):
    rng = np.random.default_rng(seed)
    out = gold.copy()
    out[:, 2:5] += rng.normal(0, sd, (len(gold), 3))
    return out


def _truncated(gold, keep):
    return gold[:keep].copy()


TESTS = {
    "itself": lambda g: g.copy(),
    "perturbed_1": lambda g: _perturbed(g, 1.0),
    "perturbed_3": lambda g: _perturbed(g, 3.0, seed=1),
    "truncated_trunk": lambda g: _truncated(g, 60),
    "truncated_half": lambda g: _truncated(g, 85),
}


@pytest.mark.parametrize("resample", [0.0, 1.0])
@pytest.mark.parametrize("case", sorted(TESTS))
def test_compare_swc_matches_jax(case, resample):
    gold = _gold()
    test = TESTS[case](gold)
    want = jax_compare_swc(test, gold, dist=4.0, resample=resample)
    got = compare_swc(test, gold, dist=4.0, resample=resample)
    assert dataclasses.asdict(got) == dataclasses.asdict(want), (got, want)


def _write_swc(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(f"{int(r[0])} {int(r[1])} {r[2]:.4f} {r[3]:.4f} {r[4]:.4f} {r[5]:.4f} "
                    f"{int(r[6])}\n")


def test_compare_cli_runs(tmp_path):
    gold = _gold()
    gold_path, test_path = tmp_path / "gold.swc", tmp_path / "test.swc"
    _write_swc(gold_path, gold)
    _write_swc(test_path, _truncated(gold, 85))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "pnr_tpu_torch.compare", str(test_path), str(gold_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want = compare_swc(read_swc(str(test_path)), read_swc(str(gold_path)), dist=4.0,
                       resample=1.0)
    assert out["f1"] == round(want.f1, 4) and out["n_gold"] == want.n_gold
    assert 0.0 < out["recall"] < 1.0 and out["precision"] > 0.95


def test_compare_cli_rejects_a_missing_file(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "pnr_tpu_torch.compare", str(tmp_path / "no.swc"),
         str(tmp_path / "gold.swc")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
