"""The plain reference against the program's plain CPU path on a small stack."""

import dataclasses

import pytest
import torch

from benchmark import run
from benchmark.core import check
from benchmark.tests._small import CONFIG, SEED, STACK
from benchmark.traffic import arbors


@pytest.fixture(scope="module", params=["exact", "tube"])
def case(request):
    from pnr_tpu_torch.pipeline.reconstruct import reconstruction_func

    torch.manual_seed(0)
    _, _, config, _ = run.load_cell("exact-arbors-single")
    cfg = dataclasses.replace(run.make_cfg(config), zncc_mode=request.param, **CONFIG)
    vol, _ = arbors.make_stack(STACK, SEED, 1, cfg.zdist, "cpu")
    vol = vol.numpy()
    res = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    return cfg, vol, res


def test_reference_agrees_with_the_program(case):
    cfg, vol, res = case
    nums = check.Reference(cfg, "cpu").compare(vol, check.outputs_of(res))
    assert len(res.seeds_pos) > 5 and len(res.n0) > 50
    assert nums["j8_off"] == 0.0
    assert nums["seed_set_off"] == 0.0
    assert nums["seed_corr_gap"] < 1e-4
    assert nums["node_corr_off"] < 0.01
    assert nums["node_sig_off"] == 0.0
    assert nums["node_step_off"] < 0.05
    assert nums["order_off"] == 0
    assert nums["tree_off"] < 0.01


def test_bfloat16_reference_in_the_program_place_is_caught(case):
    cfg, vol, res = case
    prog = check.outputs_of(res)
    ctrl = check.Reference(cfg, "cpu", torch.bfloat16).outputs(vol, prog)
    nums = check.Reference(cfg, "cpu").compare(vol, ctrl)
    assert nums["j8_off"] > 0.001
    assert nums["node_corr_off"] > 0.1
    assert nums["tree_off"] > 0.1


def test_graph_reference_follows_the_program_stage_by_stage(case):
    """The reference's tree from the program's traced nodes is the
    program's tree, and each of its steps sees the same sizes."""
    import numpy as np

    from benchmark.reference import graph

    cfg, _, res = case
    out = check.outputs_of(res)
    nodes = check.graph_input(out)
    xyz, sig, corr, soma, nb = graph.resample(nodes[:, 0:3], nodes[:, 4], nodes[:, 3],
                                              nodes[:, 5] > 0, out.links, cfg.trace_rsmpl)
    assert len(xyz) > len(nodes)
    assert all(i in nb[j] for i in range(len(nb)) for j in nb[i])  # links both ways
    moved, _ = graph.mean_shift(xyz, sig, cfg.sig2radius, cfg.refine_iter, cfg.epsilon2, "cpu",
                                torch.float64)
    assert 0 < np.abs(moved - xyz).max() < 3 * max(cfg.sigmas)
    txyz, tpar = graph.tree_of(nodes, out.links, cfg, "cpu")
    assert len(txyz) == len(res.tree) - 1
    assert graph.tree_off(out.tree_xyz, out.tree_par, txyz, tpar, check.TREE_TOL) == 0.0
