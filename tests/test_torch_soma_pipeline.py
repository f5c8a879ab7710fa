"""The port's pipeline with the soma stage against the JAX package's, on
the CPU.

`multi_neuron_soma_phantom` (tests/test_phantom_neuron.py) in exact mode
with `somaradius = 4` (ni 20) through `pnr_tpu.pipeline.reconstruction_func` and
through the port's, same config and keys: the seed sets after the soma
drop must be equal, the port must meet `TestMultiNeuronSoma`'s bars (two
SOMA nodes in n0 within 3 px of the somas, recall > 0.75, precision >
0.8), and the two F1 scores are held to each other as a paired
difference (<= 0.05). The stage's own parts are in
tests/test_torch_soma.py.
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
from pnr_tpu_torch.graph.nodes import SOMA
from pnr_tpu_torch.pipeline import reconstruct


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the phantom module's CFG in exact mode; ni 20 (traces of 40 voxels each
#: way) keeps the file's time on one core under a minute: JAX's exact
#: tracer and mean shift take most of it under the tests' CPU mesh
CFG = dataclasses.replace(jax_phantom.CFG, zncc_mode="exact", ni=20, somaradius=4)


@pytest.fixture(scope="module")
def soma_runs(tmp_path_factory):
    return once(tmp_path_factory, "soma_pipeline", lambda: _both(tmp_path_factory))


def _both(tmp_path_factory):
    from pnr_tpu.pipeline import reconstruction_func as jax_reconstruction

    vol, gold = phantoms.multi_neuron_soma_phantom()
    tmp = tmp_path_factory.mktemp("soma")
    out = {}
    for name, run in (("port", lambda: reconstruct.reconstruction_func(vol, CFG, verbose=False,
                                                                        device="cpu")),
                      ("jax", lambda: jax_reconstruction(vol, CFG, verbose=False))):
        res = run()
        path = str(tmp / f"{name}.swc")
        save_nodelist(res.tree, path)
        out[name] = (res, compare_swc(read_swc(path), gold, dist=4.0, resample=1.0))
    return out


def test_soma_pipeline_seed_sets_equal_jax(soma_runs):
    port, ref = soma_runs["port"][0], soma_runs["jax"][0]
    assert "soma extraction" in port.timings
    sp = {tuple(p) for p in port.seeds_pos.astype(int).tolist()}
    sj = {tuple(p) for p in ref.seeds_pos.astype(int).tolist()}
    assert sp == sj and len(sp) > 0


def test_soma_pipeline_passes_the_phantom_bars(soma_runs):
    """TestMultiNeuronSoma's bars (tests/test_phantom_neuron.py)."""
    res, score = soma_runs["port"]
    somas = [(res.n0.x[i], res.n0.y[i]) for i in range(1, len(res.n0)) if res.n0.type[i] == SOMA]
    assert len(somas) == 2
    for sx, sy in ((24, 28), (104, 68)):
        assert min(np.hypot(x - sx, y - sy) for x, y in somas) < 3.0
    assert score.recall > 0.75, score
    assert score.precision > 0.8, score


def test_soma_pipeline_f1_paired_with_jax(soma_runs):
    assert abs(soma_runs["port"][1].f1 - soma_runs["jax"][1].f1) <= 0.05, (
        soma_runs["port"][1], soma_runs["jax"][1],
    )
