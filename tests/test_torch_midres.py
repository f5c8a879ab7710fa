"""The port's midres results (`cfg.save_midres`) on the CPU: the result
carries the JAX package's midres keys, `reconstruct_graph(..., midres=)`
fills the reference's per-stage snapshots as pnr_tpu's does on the same
raw node graph, and the snapshots keep tests/test_pipeline.py's
invariants."""

import dataclasses

import numpy as np
import pytest
import torch

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.pipeline import reconstruct_graph, reconstruction_func
from _torch_once import once
from test_pipeline import tube_phantom


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = PNRConfig(
    sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=25,
    np=12, zdist=2.0, nodepervol=4, vol=9, wave_size=4, zncc_mode="tube",
    save_midres=True,
)
#: pnr_tpu's midres keys (pipeline/reconstruct.py: the volumes, then
#: reconstruct_graph's snapshots)
JAX_KEYS = {"vx", "vy", "vz", "trace_density", "n0", "n0tree", "n0len", "n0corr", "n0res",
            "n1", "n1len", "n2", "n2tree"}
NODE_FIELDS = ("x", "y", "z", "sig", "corr", "type")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return once(tmp_path_factory, "midres_port",
                lambda: reconstruction_func(tube_phantom(), CFG, verbose=False, device="cpu"))


def test_save_midres_returns_the_jax_keys(port):
    from pnr_tpu.pipeline import reconstruction_func as jax_reconstruction

    assert port.midres is not None, "cfg.save_midres was ignored"
    ref = jax_reconstruction(tube_phantom(), CFG, verbose=False)
    assert set(port.midres) == set(ref.midres) == JAX_KEYS
    shape = tube_phantom().shape
    for k in ("vx", "vy", "vz", "trace_density"):
        assert port.midres[k].shape == shape and port.midres[k].dtype == np.uint8, k
    # the direction volumes are the filter's: on the tube's axis, +-x
    axis = port.j8 > 200
    assert axis.any()
    ux = port.midres["vx"][axis].astype(np.float32) / 255 * 2 - 1
    assert np.median(np.abs(ux)) > 0.9
    np.testing.assert_array_equal(port.midres["trace_density"],
                                  np.clip(ref.midres["trace_density"], 0, 255))


def test_save_midres_off_returns_none():
    res = reconstruction_func(tube_phantom(), dataclasses.replace(CFG, save_midres=False),
                              verbose=False, device="cpu")
    assert res.midres is None


def test_soma_map_in_midres():
    import _torch_phantoms as phantoms

    vol = phantoms.multi_neuron_soma_phantom()[0]
    cfg = dataclasses.replace(CFG, somaradius=4, ni=10)
    res = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    smap8 = res.midres["smap8"]
    assert smap8.shape == vol.shape and smap8.dtype == np.uint8 and smap8.max() == 255


def _to_jax(nodes):
    from pnr_tpu.graph.nodes import NodeList as JaxNodeList

    out = JaxNodeList.__new__(JaxNodeList)
    for f in ("x", "y", "z", "vx", "vy", "vz", "corr", "sig", "type"):
        setattr(out, f, list(getattr(nodes, f)))
    out.nbr = [list(nb) for nb in nodes.nbr]
    return out


def test_reconstruct_graph_snapshots_match_jax(port):
    """The same n0 through both packages' reconstruct_graph: the
    snapshots before the mean shift equal, those after it within the mean
    shift's bar (atol 1e-4, test_non_blurring_matches_jax)."""
    from pnr_tpu.pipeline.reconstruct import reconstruct_graph as jax_reconstruct_graph

    n0 = port.n0
    assert len(n0) > 10
    got, want = {}, {}
    tree = reconstruct_graph(n0.copy(), CFG, "cpu", midres=got)
    ref = jax_reconstruct_graph(_to_jax(n0), CFG, midres=want)
    assert set(got) == set(want) == JAX_KEYS - {"vx", "vy", "vz", "trace_density"}
    for name in ("n0", "n0tree", "n0res", "n1", "n2", "n2tree"):
        a, b = got[name], want[name]
        assert len(a) == len(b), name
        exact = name in ("n0", "n0tree", "n0res")
        for f in NODE_FIELDS:
            if exact or f in ("corr", "type"):
                np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                              np.asarray(getattr(b, f)), err_msg=f"{name}.{f}")
            else:
                np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-4,
                                           err_msg=f"{name}.{f}")
        assert a.nbr == b.nbr, name
    for name in ("n0len", "n0corr", "n1len"):
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
    assert len(tree) == len(ref)
    np.testing.assert_allclose(tree.x, ref.x, atol=1e-4)


def test_midres_snapshot_invariants(port):
    """tests/test_pipeline.py's invariants: resampling inserts, refine
    keeps the count, grouping merges, n2tree is a forest."""
    mid = port.midres
    assert len(mid["n0res"]) >= len(mid["n0"])
    assert len(mid["n1"]) == len(mid["n0res"])
    assert len(mid["n2"]) <= len(mid["n1"])
    assert len(mid["n0len"]) >= 1
    for i in range(1, len(mid["n2tree"])):
        assert len(mid["n2tree"].nbr[i]) <= 1
