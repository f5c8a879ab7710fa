"""Batches over a mesh (pnr_tpu_torch/parallel/batch_dp.py) and sharded
serving, on the CPU.

tests/test_parallel.py's TestBatchDP and TestBatchSharded cases and
tests/test_serve.py's sharded case, on an 8-shard CPU mesh
(`make_mesh(8, device="cpu")`, the counterpart of the conftest's 8-device
JAX mesh). The reference is the port's sequential path, which
tests/test_torch_batch.py and tests/test_torch_sharded_pipeline.py hold to
JAX's: `reconstruction_batch` with `fused_frangi=False` (the batch's
filter is the unfused one, as JAX's `build_batch_filter` is) and
`reconstruction_func_sharded` on a same-size mesh. JAX's bar: node
positions within 1e-4, equal node and trace counts, equal J8.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pnr_tpu_torch import cli
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.io.swc import read_swc
from pnr_tpu_torch.io.volume import save_volume
from pnr_tpu_torch.parallel import (
    make_mesh,
    reconstruction_batch_dp,
    reconstruction_batch_sharded,
    split_mesh,
)
from pnr_tpu_torch.pipeline import reconstruction_batch, reconstruction_func_sharded
from pnr_tpu_torch.pipeline.serve import watch_and_reconstruct

MESH = make_mesh(8, device="cpu")

#: tests/test_parallel.py's TestBatchDP config, with the batch's filter
CFG = PNRConfig(
    sigmas=(2.0,), tolerance=10.0, znccth=0.5, kappa=2.0, step=2,
    ni=16, np=8, zdist=2.0, nodepervol=4, vol=9, wave_size=8,
    zncc_mode="tube", fused_frangi=False,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (tests/test_torch_sharded.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stacks(seed, n=3, shape=(8, 32, 64)):
    """tests/test_parallel.py's batch stacks: a tube at y = 16 + 2k."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        d2 = (y - 16 - 2 * k) ** 2 + ((z - 4) * 2.0) ** 2
        out.append(np.clip(200.0 * np.exp(-d2 / (2 * 2.5**2)) * (x > 5) * (x < 58)
                           + rng.normal(0, 5, shape), 0, 255).astype(np.uint8))
    return out


def planes(seed=41, n=2, shape=(1, 48, 80)):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        d2 = (y - 24 - 3 * k) ** 2
        out.append(np.clip(200.0 * np.exp(-d2 / (2 * 2.5**2)) * (x > 6) * (x < 74)
                           + rng.normal(0, 5, shape), 0, 255).astype(np.uint8))
    return out


def assert_same_run(got, want):
    assert len(got.n0) == len(want.n0) > 1, (len(got.n0), len(want.n0))
    np.testing.assert_allclose(got.n0.positions(), want.n0.positions(), atol=1e-4)
    assert got.trace_count == want.trace_count
    np.testing.assert_array_equal(got.j8, want.j8)


@pytest.mark.parametrize("n_shards", [8, 2])
def test_batch_dp_matches_sequential(n_shards):
    """tests/test_parallel.py:743; on two shards the three stacks run in two
    groups, the third stack keeping its global index for its key."""
    vols = stacks(31)
    seq = list(reconstruction_batch(vols, CFG, device="cpu", prefetch=False))
    par = reconstruction_batch_dp(vols, CFG, make_mesh(n_shards, device="cpu"), device="cpu")
    assert len(par) == 3
    for p, s in zip(par, seq):
        assert_same_run(p, s)


def test_batch_dp_2d():
    """tests/test_parallel.py:777: one plane a device, frangi2d each."""
    vols = planes()
    seq = list(reconstruction_batch(vols, CFG, device="cpu", prefetch=False))
    par = reconstruction_batch_dp(vols, CFG, MESH, device="cpu")
    for p, s in zip(par, seq):
        assert_same_run(p, s)


def test_batch_dp_takes_the_unfused_filter_whatever_the_config():
    """JAX's batch filter is unfused whatever cfg.fused_frangi says: a
    config asking for K1 gives the unfused filter's J8."""
    vols = stacks(31, n=1)
    want = reconstruction_batch_dp(vols, CFG, MESH, device="cpu")[0]
    got = reconstruction_batch_dp(vols, dataclasses.replace(CFG, fused_frangi=True), MESH,
                                  device="cpu")[0]
    np.testing.assert_array_equal(got.j8, want.j8)
    assert got.trace_count == want.trace_count


def test_batch_dp_needs_the_mesh_device_type():
    from pnr_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="not all of type 'cpu'"):
        reconstruction_batch_dp(stacks(31, n=1), CFG, Mesh((torch.device("cuda", 0),)),
                                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reconstruction_batch_dp(stacks(31, n=1), CFG, MESH)


def test_dp_times_spatial_matches_sequential():
    """tests/test_parallel.py:927: two groups of four shards stream three
    stacks; each equals `reconstruction_func_sharded` on a 4-shard mesh."""
    vols = stacks(51)
    par = reconstruction_batch_sharded(vols, CFG, MESH, groups=2)
    sub = split_mesh(MESH, 2)[0]
    for v, p in zip(vols, par):
        assert_same_run(p, reconstruction_func_sharded(v, CFG, sub, verbose=False))


def test_split_mesh_validates():
    """tests/test_parallel.py:963."""
    with pytest.raises(ValueError, match="split_mesh"):
        split_mesh(MESH, 3)
    subs = split_mesh(MESH, 4)
    assert len(subs) == 4 and all(m.size == 2 for m in subs)
    assert sum((m.devices for m in subs), ()) == MESH.devices


def tube_stack(seed):
    """tests/test_serve.py's stack."""
    rng = np.random.default_rng(seed)
    shape = (8, 32, 64)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 16) ** 2 + ((z - 4) * 2.0) ** 2
    vol = 200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
    return np.clip(vol + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


#: tests/test_serve.py's CFG with tree_size_min 3
SERVE_CFG = PNRConfig(
    sigmas=(2.0,), somaradius=0, tolerance=10.0, znccth=0.5, kappa=2.0,
    step=2, ni=12, np=8, zdist=2.0, nodepervol=4, vol=9, wave_size=8,
    zncc_mode="tube", tree_size_min=3,
)


def test_sharded_serving(tmp_path):
    """tests/test_serve.py:85: a pair of arrivals splits a 2-shard mesh into
    two 1-shard groups; each SWC equals a `reconstruction_func_sharded`
    run on a same-size mesh."""
    d = str(tmp_path)
    vols = [tube_stack(10), tube_stack(11)]
    save_volume(os.path.join(d, "a.tif"), vols[0])
    save_volume(os.path.join(d, "b.tif"), vols[1])
    open(os.path.join(d, ".stop"), "w").close()
    mesh = make_mesh(2, device="cpu")
    n = watch_and_reconstruct(d, SERVE_CFG, poll_s=0.05, verbose=False, mesh=mesh, device="cpu")
    assert n == 2
    sub = split_mesh(mesh, 2)[0]
    for name, vol in zip(("a.tif", "b.tif"), vols):
        rows = read_swc(os.path.join(d, name + "_Advantra.swc"))
        ref = reconstruction_func_sharded(vol, SERVE_CFG, sub, verbose=False)
        assert len(rows) == len(ref.tree) - 1 > 0
        np.testing.assert_allclose(rows[:, 2], np.asarray(ref.tree.x[1:]), atol=1e-3)


def test_cli_watch_mesh_serves_each_arrival(tmp_path):
    """`--watch --mesh 2 --device cpu` (pnr_tpu/cli.py's --watch branch):
    one SWC per arrival, each the sharded run's tree on a 1-shard group."""
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    vols = [tube_stack(12), tube_stack(13)]
    for name, v in zip(("a.tif", "b.tif"), vols):
        save_volume(str(src / name), v)
    (src / ".stop").touch()
    params = ["2", "0", "10", "0.5", "2", "2", "12", "8", "2", "4", "9"]
    assert cli.main(["-i", str(src), "-p", *params, "--watch", "--mesh", "2", "--device", "cpu",
                     "--zncc-mode", "tube", "-o", str(out), "--quiet"]) == 0
    cfg = dataclasses.replace(PNRConfig.from_cli_params(params), zncc_mode="tube")
    sub = make_mesh(1, device="cpu")
    for name, v in zip(("a.tif", "b.tif"), vols):
        rows = read_swc(str(out / (name + "_Advantra.swc")))
        ref = reconstruction_func_sharded(v, cfg, sub, verbose=False)
        assert len(rows) == len(ref.tree) - 1
