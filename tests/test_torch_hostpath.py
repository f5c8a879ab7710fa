"""The port's host one-shot engine (pnr_tpu_torch/hostpath) against the
JAX package's, on the CPU.

The engine is NumPy, SciPy and the native runtime in both packages (the
port's modules are copies), so the bar is bitwise: on the branching
phantom, exact and tube, the port's SWC nodes equal JAX's. The CLI with
PNR_TPU_HOST_PATH=1 writes JAX's SWC; without it, `--device cuda` on a
machine with no card fails and never falls back to the host engine.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_phantom_neuron as phantom
from pnr_tpu import cli as jax_cli
from pnr_tpu.hostpath import host_reconstruction_func as jax_host
from pnr_tpu_torch import cli, hostpath
from pnr_tpu_torch.hostpath import host_reconstruction_func


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARAMS = ["2,3", "0", "10", "0.5", "2", "2", "20", "16", "2", "4", "9"]


def _nodes(nl):
    return (np.array([nl.x, nl.y, nl.z, nl.sig, nl.corr], np.float64), list(nl.type),
            [sorted(n) for n in nl.nbr])


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_host_engine_bitwise_jax(mode):
    vol, _ = phantom.branching_neuron_phantom()
    cfg = dataclasses.replace(phantom.CFG, zncc_mode=mode, ni=20)
    got = host_reconstruction_func(vol, cfg, verbose=False)
    want = jax_host(vol, cfg, verbose=False)
    assert len(want.tree) > 10
    assert np.array_equal(got.seeds_pos, want.seeds_pos)
    for a, b in zip(_nodes(got.n0), _nodes(want.n0)):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    for a, b in zip(_nodes(got.tree), _nodes(want.tree)):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_cli_host_path_writes_jax_swc(tmp_path, monkeypatch):
    src = tmp_path / "stack.npy"
    np.save(src, phantom.branching_neuron_phantom()[0])
    monkeypatch.setenv("PNR_TPU_HOST_PATH", "1")
    port_out, jax_out = tmp_path / "port.swc", tmp_path / "jax.swc"
    assert cli.main(["-i", str(src), "-p", *PARAMS, "-o", str(port_out), "--quiet"]) == 0
    assert jax_cli.main(["-i", str(src), "-p", *PARAMS, "-o", str(jax_out), "--quiet"]) == 0
    text = port_out.read_text()
    assert len(text.splitlines()) > 10
    assert text == jax_out.read_text()


def test_cli_without_host_path_needs_a_card(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "stack.npy"
    np.save(src, np.zeros((8, 16, 16), np.uint8))
    monkeypatch.delenv("PNR_TPU_HOST_PATH", raising=False)

    def never(*a, **k):
        raise AssertionError("the host engine ran unasked")

    monkeypatch.setattr(hostpath, "host_reconstruction_func", never)
    rc = cli.main(["-i", str(src), "-p", *PARAMS, "--device", "cuda"])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err
