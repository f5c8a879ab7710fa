"""The port's serve mode (pnr_tpu_torch/pipeline/serve.py) on the CPU:
tests/test_serve.py's cases on `device="cpu"`; each served SWC equals the
batch driver's tree for its stack, and a mesh of another device type than
the server's raises. The sharded case (a mesh) is in
tests/test_torch_batch_dp.py."""

import os
import threading
import time

import numpy as np

import pytest
import torch

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.io.swc import read_swc
from pnr_tpu_torch.io.volume import save_volume
from pnr_tpu_torch.pipeline import reconstruction_batch
from pnr_tpu_torch.pipeline.serve import watch_and_reconstruct as _watch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def watch_and_reconstruct(*args, **kwargs):
    return _watch(*args, device="cpu", **kwargs)

CFG = PNRConfig(
    sigmas=(2.0,), somaradius=0, tolerance=10.0, znccth=0.5, kappa=2.0,
    step=2, ni=12, np=8, zdist=2.0, nodepervol=4, vol=9, wave_size=8,
    zncc_mode="tube",
)


def tube_stack(seed=0, shape=(8, 32, 64)):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 16) ** 2 + ((z - 4) * 2.0) ** 2
    vol = 200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
    return np.clip(vol + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


class TestServe:
    def test_preexisting_files_then_stop(self, tmp_path):
        import json

        d = str(tmp_path)
        save_volume(os.path.join(d, "a.tif"), tube_stack(0))
        save_volume(os.path.join(d, "b.tif"), tube_stack(1))
        open(os.path.join(d, ".stop"), "w").close()
        metrics = str(tmp_path / "metrics.jsonl")
        n = watch_and_reconstruct(
            d, CFG, poll_s=0.05, verbose=False, metrics_path=metrics
        )
        assert n == 2
        for name in ("a.tif", "b.tif"):
            out = os.path.join(d, name + "_Advantra.swc")
            assert os.path.exists(out)
            assert len(open(out).read().splitlines()) > 3
        # a run-start line (params + timestamp, so consumers can split
        # appended runs), then one JSON line per served stack
        lines = [json.loads(L) for L in open(metrics)]
        assert "run_start" in lines[0] and "params" in lines[0]
        lines = lines[1:]
        assert sorted(os.path.basename(e["image"]) for e in lines) == [
            "a.tif", "b.tif",
        ]
        for e in lines:
            assert e["tree_nodes"] > 0 and e["timings_s"]

    def test_file_arriving_while_serving(self, tmp_path):
        """A stack dropped in mid-serve is picked up once size-stable;
        the loop drains it before honouring the stop sentinel."""
        d = str(tmp_path)
        save_volume(os.path.join(d, "first.tif"), tube_stack(2))

        def drop_later():
            time.sleep(0.4)
            save_volume(os.path.join(d, "late.tif"), tube_stack(3))
            time.sleep(0.4)
            open(os.path.join(d, ".stop"), "w").close()

        t = threading.Thread(target=drop_later)
        t.start()
        n = watch_and_reconstruct(d, CFG, poll_s=0.05, verbose=False)
        t.join()
        assert n == 2
        assert os.path.exists(os.path.join(d, "late.tif_Advantra.swc"))

    def test_unreadable_file_skipped(self, tmp_path):
        d = str(tmp_path)
        with open(os.path.join(d, "broken.tif"), "wb") as f:
            f.write(b"not a tif at all")
        save_volume(os.path.join(d, "good.tif"), tube_stack(4))
        open(os.path.join(d, ".stop"), "w").close()
        n = watch_and_reconstruct(d, CFG, poll_s=0.05, verbose=False)
        assert n == 1
        assert os.path.exists(os.path.join(d, "good.tif_Advantra.swc"))

    def test_single_stack_served_without_future_arrivals(self, tmp_path):
        """Liveness: one arrived stack must be reconstructed promptly —
        its SWC must NOT be gated on later stacks or the stop sentinel
        (the batch driver's prefetch must not block pulling the feed
        while work is queued)."""
        d = str(tmp_path)
        done = threading.Event()

        def serve():
            watch_and_reconstruct(d, CFG, poll_s=0.05, verbose=False)
            done.set()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        time.sleep(0.2)  # server idles on an empty dir
        save_volume(os.path.join(d, "solo.tif"), tube_stack(7))
        out = os.path.join(d, "solo.tif_Advantra.swc")
        deadline = time.time() + 60.0
        while not os.path.exists(out) and time.time() < deadline:
            time.sleep(0.1)
        # the SWC appears while the server is still running
        assert os.path.exists(out), "arrived stack was not served"
        assert not done.is_set()
        open(os.path.join(d, ".stop"), "w").close()
        t.join(timeout=30.0)
        assert done.is_set()

    def test_idle_poll_does_not_stall_critical_path(self, tmp_path):
        """The feed's not-ready signal must not sleep poll_s on the
        critical path: with a huge poll interval, a pre-existing stack +
        stop sentinel still completes promptly (the feed throttles only
        when re-polled FASTER than poll_s — i.e. when the driver is
        idle-spinning, never on a mid-pipeline top-up after work)."""
        d = str(tmp_path)
        save_volume(os.path.join(d, "quick.tif"), tube_stack(9))
        open(os.path.join(d, ".stop"), "w").close()
        t0 = time.time()
        n = watch_and_reconstruct(d, CFG, poll_s=60.0, verbose=False)
        elapsed = time.time() - t0
        assert n == 1
        # the old sleep-before-None behaviour guaranteed >= poll_s here
        # (the first scan sees quick.tif unstable -> not-ready path)
        assert elapsed < 50.0, f"idle poll stalled the pipeline: {elapsed:.1f}s"

    def test_scan_prunes_vanished_candidate(self, tmp_path):
        """A file that vanishes mid-stability-check must not leave a
        stale `sizes` entry (it would block the drain-before-stop
        check forever). `seen` stays bounded by the directory, but a
        SINGLE missed poll (transient stat failure / NFS hiccup) must
        NOT prune a served file's entry — that would re-reconstruct an
        unchanged stack when it reappears with the same stamp."""
        from pnr_tpu_torch.pipeline.serve import _PRUNE_AFTER_MISSES, _scan

        d = str(tmp_path)
        seen, sizes, missing = set(), {}, {}
        p = os.path.join(d, "gone.tif")
        with open(p, "wb") as f:
            f.write(b"x" * 64)
        assert _scan(d, seen, sizes, missing) == []  # first sighting
        assert sizes
        os.remove(p)
        assert _scan(d, seen, sizes, missing) == []
        assert not sizes, "vanished candidate must be pruned"
        # a served file must survive transient absence...
        q = os.path.join(d, "served.tif")
        with open(q, "wb") as f:
            f.write(b"y" * 64)
        _scan(d, seen, sizes, missing)
        assert _scan(d, seen, sizes, missing) == [q]
        assert seen
        data = open(q, "rb").read()
        st = os.stat(q)
        os.remove(q)
        _scan(d, seen, sizes, missing)  # one missed poll: NOT pruned
        with open(q, "wb") as f:
            f.write(data)
        os.utime(q, ns=(st.st_atime_ns, st.st_mtime_ns))
        assert _scan(d, seen, sizes, missing) == [], "same-stamp reappearance re-served"
        # ...but a persistently absent file is pruned (bounded memory)
        os.remove(q)
        for _ in range(_PRUNE_AFTER_MISSES):
            _scan(d, seen, sizes, missing)
        assert not seen

    def test_rewritten_candidate_restarts_stability_check(self, tmp_path):
        """Same size but new mtime between polls = still being written;
        must not be yielded until the (mtime, size) stamp repeats."""
        from pnr_tpu_torch.pipeline.serve import _scan

        d = str(tmp_path)
        seen, sizes = set(), {}
        p = os.path.join(d, "slow.tif")
        with open(p, "wb") as f:
            f.write(b"x" * 64)
        assert _scan(d, seen, sizes) == []
        os.utime(p, ns=(1, 1))  # rewrite: same size, different mtime
        assert _scan(d, seen, sizes) == [] , "unstable mtime must re-arm"
        assert _scan(d, seen, sizes) == [p]

    def test_out_dir_and_max_stacks(self, tmp_path):
        d = str(tmp_path / "in")
        o = str(tmp_path / "out")
        os.makedirs(d)
        os.makedirs(o)
        save_volume(os.path.join(d, "a.tif"), tube_stack(5))
        save_volume(os.path.join(d, "b.tif"), tube_stack(6))
        n = watch_and_reconstruct(
            d, CFG, out_dir=o, poll_s=0.05, verbose=False, max_stacks=1
        )
        assert n == 1
        assert os.path.exists(os.path.join(o, "a.tif_Advantra.swc"))

    def test_served_swcs_are_the_batch_trees(self, tmp_path):
        """Each SWC equals the tree `reconstruction_batch` gives its stack
        (the files are consumed in sorted order, stack i keyed fold_in(key, i))."""
        d = str(tmp_path)
        vols = [tube_stack(12), tube_stack(13)]
        for name, vol in zip(("a.tif", "b.tif"), vols):
            save_volume(os.path.join(d, name), vol)
        open(os.path.join(d, ".stop"), "w").close()
        assert watch_and_reconstruct(d, CFG, poll_s=0.05, verbose=False) == 2
        trees = [r.tree for r in reconstruction_batch(vols, CFG, device="cpu")]
        for name, tree in zip(("a.tif", "b.tif"), trees):
            rows = read_swc(os.path.join(d, name + "_Advantra.swc"))
            assert len(rows) == len(tree) - 1
            np.testing.assert_allclose(rows[:, 2], np.asarray(tree.x[1:]), atol=1e-3)

    def test_mesh_raises(self, tmp_path):
        """Sharded serving is ported (tests/test_torch_batch_dp.py); a mesh
        whose devices are not of the server's device type raises."""
        import torch

        from pnr_tpu_torch.parallel import Mesh

        mesh = Mesh((torch.device("cuda", 0),) * 2)
        with pytest.raises(ValueError, match="not of type 'cpu'"):
            watch_and_reconstruct(str(tmp_path), CFG, mesh=mesh)
        with pytest.raises(ValueError, match="not of type 'cpu'"):
            watch_and_reconstruct(str(tmp_path), CFG, mesh=mesh, dp_groups=2)

    def test_default_device_needs_a_card(self, tmp_path):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the no-card path cannot be exercised")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _watch(str(tmp_path), CFG, poll_s=0.05, verbose=False)
