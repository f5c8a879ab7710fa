"""The port's pipeline as a whole against the JAX package, on the CPU.

The branching-neuron phantom of tests/test_phantom_neuron.py runs
through `pnr_tpu.pipeline.reconstruction_func` and through the port's,
in exact mode and in tube mode (the phantom gate's own config), same
config and keys. The seed sets must agree, the port must pass the JAX
package's quality gate for the mode, and the two F1 scores are held to
each other as a paired difference on the same phantom.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_phantom_neuron as phantom
from _torch_once import once
from pnr_tpu.graph.nodes import NodeList
from pnr_tpu.io.swc import read_swc, save_nodelist
from pnr_tpu.utils.swc_compare import compare_swc
from pnr_tpu_torch import cli
from pnr_tpu_torch.graph.refine import non_blurring


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(phantom.CFG, zncc_mode="exact", ni=40)


def _score(res, gold, path):
    save_nodelist(res.tree, path)
    return compare_swc(read_swc(path), gold, dist=4.0, resample=1.0)


def _both(cfg, tmp_path_factory):
    from pnr_tpu.pipeline import reconstruction_func as jax_reconstruction
    from pnr_tpu_torch.pipeline import reconstruction_func as port_reconstruction

    vol, gold = phantom.branching_neuron_phantom()
    tmp = tmp_path_factory.mktemp("swc")
    port = port_reconstruction(vol, cfg, verbose=False, device="cpu")
    ref = jax_reconstruction(vol, cfg, verbose=False)
    return {
        "port": (port, _score(port, gold, str(tmp / "port.swc"))),
        "jax": (ref, _score(ref, gold, str(tmp / "jax.swc"))),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once(tmp_path_factory, "pipeline_exact", lambda: _both(CFG, tmp_path_factory))


@pytest.fixture(scope="module")
def tube_runs(tmp_path_factory):
    return once(tmp_path_factory, "pipeline_tube", lambda: _both(phantom.CFG, tmp_path_factory))


def test_seed_sets_match(runs):
    port, ref = runs["port"][0], runs["jax"][0]
    sp = {tuple(p) for p in port.seeds_pos.astype(int).tolist()}
    sj = {tuple(p) for p in ref.seeds_pos.astype(int).tolist()}
    assert len(sp & sj) >= 0.9 * max(len(sp), len(sj), 1), (len(sp), len(sj))


def test_port_passes_exact_quality_gate(runs):
    res, score = runs["port"]
    assert score.recall > 0.8, score
    assert score.precision > 0.85, score
    assert score.f1 > 0.85, score
    assert set(res.timings) == {
        "frangi", "seed extraction", "seed selection & sorting", "tracing", "reconstruct",
    }


def test_f1_paired_with_jax(runs):
    assert abs(runs["port"][1].f1 - runs["jax"][1].f1) <= 0.05, (
        runs["port"][1], runs["jax"][1],
    )


def test_tube_seed_sets_identical(tube_runs):
    port, ref = tube_runs["port"][0], tube_runs["jax"][0]
    assert port.zncc_mode == ref.zncc_mode == "tube"
    sp = {tuple(p) for p in port.seeds_pos.astype(int).tolist()}
    sj = {tuple(p) for p in ref.seeds_pos.astype(int).tolist()}
    assert sp == sj and len(sp) > 0


def test_tube_port_passes_phantom_gate(tube_runs):
    """tests/test_phantom_neuron.py's tube-mode gate."""
    score = tube_runs["port"][1]
    assert score.f1 > 0.88, score
    assert score.precision > 0.9, score


def test_tube_f1_paired_with_jax(tube_runs):
    assert abs(tube_runs["port"][1].f1 - tube_runs["jax"][1].f1) <= 0.05, (
        tube_runs["port"][1], tube_runs["jax"][1],
    )


def test_tube_low_signal_warning(capsys):
    """At SNR 3.8 the tube likelihood rejects every candidate: the shared
    diagnostic flags the tube engine, as it does for pnr_tpu."""
    from pnr_tpu.utils.exporters import low_signal_diagnostic
    from pnr_tpu_torch.pipeline import reconstruction_func

    vol, _gold, snr = phantom.snr_phantom(40)
    assert snr < 4.5
    res = reconstruction_func(vol, phantom.CFG, verbose=False, device="cpu")
    warn = low_signal_diagnostic(res)
    assert warn is not None and warn["engine"] == "tube"
    assert warn["raw_maxima"] > 0 and warn["committed_nodes"] == 0
    assert "WARNING low-signal" in capsys.readouterr().err


def test_non_blurring_matches_jax():
    from pnr_tpu.graph.refine import non_blurring as jax_non_blurring

    rng = np.random.default_rng(4)
    nodes = NodeList()
    for _ in range(300):
        nodes.add(*rng.uniform(0, 40, 3), sig=float(rng.uniform(1.0, 3.0)))
    want = jax_non_blurring(nodes, 1.5, 4, 1e-4)
    got = non_blurring(nodes, 1.5, 4, 1e-4, "cpu")
    for axis in ("x", "y", "z", "sig"):
        np.testing.assert_allclose(getattr(got, axis), getattr(want, axis), atol=1e-4)


def _run_cli(tmp_path, vol, mode, params):
    src = tmp_path / "stack.npy"
    np.save(src, vol)
    out, metrics = tmp_path / "out.swc", tmp_path / "m.json"
    # one OpenMP thread, as tests/test_torch_multiprocess.py's children: the
    # suite's workers share the host's cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [
            sys.executable, "-m", "pnr_tpu_torch", "-i", str(src), "-p", *params,
            "-o", str(out), "--metrics", str(metrics), "--device", "cpu", "--zncc-mode", mode,
        ],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"zncc_mode = {mode}" in proc.stdout
    swc = read_swc(str(out))
    entry = json.loads(metrics.read_text())["stacks"][0]
    assert entry["tree_nodes"] == len(swc)
    return swc, entry, proc.stdout


def _cli_round_trip(tmp_path, mode):
    vol = phantom.branching_neuron_phantom()[0]
    swc, _, _ = _run_cli(tmp_path, vol, mode,
                         ["2,3", "0", "10", "0.5", "2", "2", "20", "16", "2", "4", "9"])
    assert len(swc) > 10
    assert abs(np.median(swc[:, 3]) - 36) < 8  # the phantom's trunk row


def test_cli_round_trip(tmp_path):
    _cli_round_trip(tmp_path, "exact")


def test_cli_tube_round_trip(tmp_path):
    _cli_round_trip(tmp_path, "tube")


def test_cli_2d_round_trip(tmp_path):
    """A one-plane .npy stack (zdist 1): the SWC stays in the plane."""
    vol = phantom.branching_neuron_phantom_2d()[0]
    swc, _, _ = _run_cli(tmp_path, vol, "exact",
                         ["2,3", "0", "10", "0.5", "2", "2", "20", "16", "1", "4", "9"])
    assert len(swc) > 10
    assert abs(np.median(swc[:, 3]) - 40) < 8  # the phantom's trunk row
    assert np.all(np.abs(swc[:, 4]) <= 1.0)


def test_cli_soma_round_trip(tmp_path):
    """somaradius 4 on the two-soma phantom: the soma stage runs and the
    SWC carries soma-typed nodes near both somas."""
    vol = phantom.multi_neuron_soma_phantom()[0]
    swc, entry, out = _run_cli(tmp_path, vol, "tube",
                               ["2,3", "4", "10", "0.5", "2", "2", "20", "16", "2", "4", "9"])
    assert "somaradius = 4" in out
    assert "soma extraction" in entry["timings_s"]
    somas = swc[swc[:, 1] == 1]
    for sx, sy in ((24, 28), (104, 68)):
        assert np.hypot(somas[:, 2] - sx, somas[:, 3] - sy).min() < 10.0


def test_cli_default_device_needs_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "stack.npy"
    np.save(src, np.zeros((8, 16, 16), np.uint8))
    rc = cli.main(["-i", str(src), "-p", "2,3", "0", "10", "0.5", "2", "2", "20", "16", "2", "4", "9"])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err
