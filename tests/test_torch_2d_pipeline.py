"""The port's 2-D (P == 1) pipeline against the JAX package's, on the CPU.

`branching_neuron_phantom_2d` (tests/test_phantom_neuron.py) with
`Test2DPhantom`'s config (the phantom module's CFG with zdist = 1.0)
through `pnr_tpu.pipeline.reconstruction_func` and through the port's,
same config and keys, in exact and in tube mode: the seed sets must be
equal, the port must meet `Test2DPhantom`'s bars (recall > 0.75,
precision > 0.85, every node within 1 of the plane), and the two F1
scores are held to each other as a paired difference (<= 0.05). The 2-D
parts are in tests/test_torch_2d.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_phantoms as phantoms
import test_phantom_neuron as jax_phantom
from _torch_once import once
from pnr_tpu.io.swc import read_swc, save_nodelist
from pnr_tpu.utils.swc_compare import compare_swc
from pnr_tpu_torch.pipeline import reconstruct


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODES = ["exact", "tube"]


@pytest.fixture(scope="module", params=MODES)
def runs(request, tmp_path_factory):
    mode = request.param
    return mode, once(tmp_path_factory, f"2d_pipeline_{mode}", lambda: _both(mode, tmp_path_factory))


def _both(mode, tmp_path_factory):
    from pnr_tpu.pipeline import reconstruction_func as jax_reconstruction

    cfg = dataclasses.replace(jax_phantom.CFG, zdist=1.0, zncc_mode=mode)
    vol, gold = phantoms.branching_neuron_phantom_2d()
    tmp = tmp_path_factory.mktemp("plane")
    out = {}
    for name, run in (("port", lambda: reconstruct.reconstruction_func(vol, cfg, verbose=False,
                                                                        device="cpu")),
                      ("jax", lambda: jax_reconstruction(vol, cfg, verbose=False))):
        res = run()
        path = str(tmp / f"{name}.swc")
        save_nodelist(res.tree, path)
        out[name] = (res, compare_swc(read_swc(path), gold, dist=4.0, resample=1.0))
    return out


def test_2d_seed_sets_equal_jax(runs):
    mode, out = runs
    port, ref = out["port"][0], out["jax"][0]
    assert port.zncc_mode == mode
    sp = {tuple(p) for p in port.seeds_pos.astype(int).tolist()}
    sj = {tuple(p) for p in ref.seeds_pos.astype(int).tolist()}
    assert sp == sj and len(sp) > 0
    assert bool((port.seeds_pos[:, 2] == 0).all())


def test_2d_passes_the_phantom_bars(runs):
    """Test2DPhantom's bars (tests/test_phantom_neuron.py)."""
    _, out = runs
    res, score = out["port"]
    assert score.recall > 0.75, score
    assert score.precision > 0.85, score
    assert np.allclose(res.tree.z[1:], 0.0, atol=1.0)


def test_2d_f1_paired_with_jax(runs):
    _, out = runs
    assert abs(out["port"][1].f1 - out["jax"][1].f1) <= 0.05, (out["port"][1], out["jax"][1])
