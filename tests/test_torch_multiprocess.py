"""The port's multi-process runtime (pnr_tpu_torch/parallel/multihost.py)
across a real process boundary, on the CPU.

tests/test_multiprocess.py's three cases, on torch.distributed: two
processes of tests/_torch_mp_child.py (jax-free) join a gloo group, each
with four CPU shards of a global eight-shard mesh. Bars (JAX's): the
sharded filter bitwise the monolithic one on every shard; the per-shard
seed set equal to the host flood on the gathered J8, with no volume-sized
gather; the full 3-D and 2-D pipeline equal to the single-process
eight-shard port run: J8, node types and trace and tree counts equal,
node coordinates within 1e-4. Each child has 120 s.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_mp_child.py")
TIMEOUT_S = 120

pytestmark = pytest.mark.skipif(not torch.distributed.is_gloo_available(),
                                reason="torch.distributed has no gloo backend")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(case: str, *extra: str) -> list:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, CHILD, case, str(rank), port, *extra], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


def test_two_process_sharded_frangi():
    for out in _run_pair("frangi"):
        assert "bitwise across the process boundary" in out


def test_two_process_per_shard_seeds():
    for out in _run_pair("seeds"):
        assert "per-shard seeds OK" in out


def test_two_process_full_pipeline(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from _torch_mp_child import MP_CFG, MP_CFG_2D, mp_phantom, mp_phantom_2d

    from pnr_tpu_torch.parallel import make_mesh
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    out = str(tmp_path / "mp.npz")
    for o in _run_pair("pipeline", out):
        assert "full sharded pipeline OK" in o
    got = np.load(out)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = make_mesh(8, device="cpu")
        ref = reconstruction_func_sharded(mp_phantom(), MP_CFG, mesh, verbose=False)
        ref2 = reconstruction_func_sharded(mp_phantom_2d(), MP_CFG_2D, mesh, verbose=False)
    finally:
        torch.set_num_threads(n)
    assert int(got["trace_count"]) == ref.trace_count
    assert int(got["tree_n"]) == len(ref.tree)
    assert int(got["n_handoffs"]) == ref.n_handoffs
    np.testing.assert_array_equal(got["ntype"], np.asarray(ref.n0.type))
    for k, v in (("x", ref.n0.x), ("y", ref.n0.y), ("z", ref.n0.z), ("sig", ref.n0.sig)):
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-4)
    np.testing.assert_array_equal(got["j8"], ref.j8)
    assert int(got["received"]) > 0  # the processes did exchange data
    assert int(got["tree_n_2d"]) == len(ref2.tree)
    assert int(got["trace_count_2d"]) == ref2.trace_count
    np.testing.assert_allclose(got["x_2d"], np.asarray(ref2.n0.x), atol=1e-4)
    np.testing.assert_allclose(got["y_2d"], np.asarray(ref2.n0.y), atol=1e-4)
    np.testing.assert_array_equal(got["j8_2d"], ref2.j8)


# -- the runtime in one process and the mesh's bookkeeping (no group) ------------------


def test_one_process_runtime_passes_through():
    """Without a process group every collective is this process's own data,
    and a global mesh is a plain one."""
    from pnr_tpu_torch.parallel import multihost as mh
    from pnr_tpu_torch.parallel import Mesh, make_mesh

    assert mh.process_count() == 1 and mh.process_index() == 0
    obj = {"a": np.arange(3)}
    assert mh.exchange(obj) == [obj]
    rows = np.ones((4, 6), np.float32)
    assert mh.allgather_host_rows(rows) is rows
    mesh = mh.make_global_mesh(device=("cpu",) * 3)
    assert mesh == make_mesh(3, device="cpu") and not mesh.multiprocess
    vol = np.arange(6 * 2 * 3, dtype=np.uint8).reshape(6, 2, 3)
    shards = mh.shard_volume_global(vol, mesh)
    assert np.array_equal(mh.fetch_replicated(shards), vol)
    assert isinstance(mesh, Mesh)


def test_mesh_records_each_shards_process():
    """A mesh over two processes: this process's shards, its devices, and
    the ranks kept by split_mesh; the sharded layer's lists hold None for
    the other process's shards, whose halo planes need the mesh."""
    from pnr_tpu_torch.parallel import Mesh, halo_exchange_z_aligned, shard_volume, split_mesh

    cpu = torch.device("cpu")
    mesh = Mesh((cpu,) * 4, ranks=(0, 0, 1, 1), rank=1)
    assert mesh.multiprocess and [mesh.is_local(i) for i in range(4)] == [False, False, True, True]
    assert mesh.local_devices == (cpu,)
    assert [m.ranks for m in split_mesh(mesh, 2)] == [(0, 0), (1, 1)]
    shards = shard_volume(np.zeros((8, 2, 2), np.uint8), mesh)
    assert [t is None for t in shards] == [True, True, False, False]
    with pytest.raises(ValueError, match="needs its mesh"):
        halo_exchange_z_aligned(shards, 1)
    assert not Mesh((cpu,) * 2, ranks=(0, 0)).multiprocess


def test_a_batch_does_not_span_processes():
    from pnr_tpu_torch.config import PNRConfig
    from pnr_tpu_torch.parallel import Mesh, reconstruction_batch_dp, reconstruction_batch_sharded

    mesh = Mesh((torch.device("cpu"),) * 2, ranks=(0, 1))
    vols = [np.zeros((2, 8, 8), np.uint8)]
    with pytest.raises(ValueError, match="spans several"):
        reconstruction_batch_dp(vols, PNRConfig(), mesh, device="cpu")
    with pytest.raises(ValueError, match="spans several"):
        reconstruction_batch_sharded(vols, PNRConfig(), mesh)
