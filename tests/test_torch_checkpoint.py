"""The port's checkpoint and resume (pipeline/checkpoint.py, the
`checkpoint_path`/`resume` arguments of `reconstruction_func`) on the CPU:
the state round-trips, the `.npz` format is the JAX package's (each loads
the other's), a resume refuses a missing file or another volume's
snapshot as JAX's does, and a run cut by the trace cap then resumed is
bitwise the uninterrupted run (tests/test_checkpoint_and_compare.py's
cases, on the port)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.graph.build import TraceCommitter
from pnr_tpu_torch.graph.nodes import NodeList
from pnr_tpu_torch.pipeline import reconstruction_func
from pnr_tpu_torch.pipeline.checkpoint import load_checkpoint, save_checkpoint
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
)


def committer(nodes_cls, committer_cls, smap=False):
    """A small committed state: three nodes, one link, stamped maps."""
    nodes = nodes_cls()
    nodes.add(1, 2, 3, 0.5, 0.5, 0, corr=0.7, sig=2.0, ntype=2)
    nodes.add(4, 5, 6, corr=0.8, sig=1.5, ntype=6)
    nodes.link(1, 2)
    sm = np.arange(4 * 8 * 8, dtype=np.int32).reshape(4, 8, 8) % 3 if smap else None
    c = committer_cls((4, 8, 8), vol=9, nodepervol=3, nodes=nodes, smap=sm)
    c.npervol[1, 2, 3] = 2
    c.nidx[1, 2, 3] = 1
    return c


def run(vol, cfg=CFG, **kw):
    return reconstruction_func(vol, cfg, verbose=False, device="cpu", **kw)


def test_roundtrip_state(tmp_path):
    c = committer(NodeList, TraceCommitter)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, c, seed_cursor=7, trace_count=3, pending=[5, 6], nseeds=40)
    c2, cursor, count, pending, nseeds = load_checkpoint(p)
    assert (cursor, count, pending, nseeds) == (7, 3, [5, 6], 40)
    assert len(c2.nodes) == 3
    assert c2.nodes.nbr[1] == [2] and c2.nodes.nbr[2] == [1]
    assert c2.npervol[1, 2, 3] == 2 and c2.nidx[1, 2, 3] == 1
    assert c2.vol == 9 and c2.nodepervol == 3 and c2.smap is None
    assert not os.path.exists(p + ".tmp.npz")  # the write is atomic


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_in_the_other_package(tmp_path, writer):
    """Both packages write the same arrays under the same names and
    dtypes, and each loads the other's file to the same state."""
    from pnr_tpu.graph.build import TraceCommitter as JaxCommitter
    from pnr_tpu.graph.nodes import NodeList as JaxNodeList
    from pnr_tpu.pipeline import checkpoint as jax_checkpoint

    ours = str(tmp_path / "port.npz")
    theirs = str(tmp_path / "jax.npz")
    args = dict(seed_cursor=11, trace_count=4, pending=[2, 9], nseeds=30)
    save_checkpoint(ours, committer(NodeList, TraceCommitter, smap=True), **args)
    jax_checkpoint.save_checkpoint(theirs, committer(JaxNodeList, JaxCommitter, smap=True),
                                   **args)
    a, b = np.load(ours), np.load(theirs)
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # each loader gives one state from either file (float32 node fields)
    states = [load(f) for load in (load_checkpoint, jax_checkpoint.load_checkpoint)
              for f in ((theirs, ours) if writer == "jax" else (ours, theirs))]
    for c, *rest in states:
        assert rest == [11, 4, [2, 9], 30]
        assert c.shape == (4, 8, 8) and c.vol == 9 and c.nodepervol == 3
        first = states[0][0]
        for f in ("x", "y", "z", "vx", "vy", "vz", "corr", "sig", "type", "nbr"):
            assert getattr(c.nodes, f) == getattr(first.nodes, f), f
        ref = committer(NodeList, TraceCommitter, smap=True)
        for f in ("npervol", "nidx", "smap"):
            np.testing.assert_array_equal(getattr(c, f), getattr(ref, f))
        assert c.nodes.nbr == ref.nodes.nbr
        np.testing.assert_array_equal(np.float32(c.nodes.corr), np.float32(ref.nodes.corr))


def test_resume_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run(tube_phantom(), checkpoint_path=str(tmp_path / "nope.npz"), resume=True)


def test_resume_wrong_volume_raises(tmp_path):
    c = TraceCommitter((4, 8, 8), vol=9, nodepervol=3, nodes=NodeList())
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, c, seed_cursor=0, trace_count=0)
    with pytest.raises(ValueError, match="volume"):
        run(tube_phantom(), checkpoint_path=p, resume=True)


def test_resume_wrong_seed_count_raises(tmp_path):
    vol = tube_phantom()
    c = TraceCommitter(vol.shape, vol=9, nodepervol=3, nodes=NodeList())
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, c, seed_cursor=0, trace_count=0, nseeds=10**6)
    with pytest.raises(ValueError, match="seeds"):
        run(vol, checkpoint_path=p, resume=True)


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    return once(tmp_path_factory, "checkpoint_full", lambda: run(tube_phantom()))


def test_resume_after_midwave_cap(tmp_path, full):
    """A cap that fires inside a wave leaves selected, unstarted seeds in
    the checkpoint's pending list; resuming with the cap lifted is
    bitwise the uninterrupted run."""
    assert full.trace_count > 2
    ck = str(tmp_path / "cap.npz")
    part = run(tube_phantom(), dataclasses.replace(CFG, max_trace_count=1), checkpoint_path=ck)
    assert 0 < part.trace_count < full.trace_count
    assert np.load(ck)["pending"].size > 0, "the cap did not cut mid-wave; the test is inert"
    resumed = run(tube_phantom(), checkpoint_path=ck, resume=True)
    assert resumed.trace_count == full.trace_count
    for a, b in ((resumed.n0, full.n0), (resumed.tree, full.tree)):
        assert len(a) == len(b)
        for f in ("x", "y", "z", "sig", "corr", "type"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
        assert a.nbr == b.nbr


def test_checkpoint_every_wave_then_resume_is_the_same_run(tmp_path, full):
    ck = str(tmp_path / "run.npz")
    again = run(tube_phantom(), checkpoint_path=ck, checkpoint_every_waves=1)
    resumed = run(tube_phantom(), checkpoint_path=ck, resume=True)
    for r in (again, resumed):
        np.testing.assert_array_equal(np.asarray(r.n0.x), np.asarray(full.n0.x))
        np.testing.assert_array_equal(np.asarray(r.tree.x), np.asarray(full.tree.x))
