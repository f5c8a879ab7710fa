"""The port's `reconstruction_batch` on the CPU: prefetch on and off give
bitwise the same results, stack i is `reconstruction_func` with the key
fold_in(key, i), the port's fold_in is jax's, and the feed's edge cases
(an empty list, a generator, a deep prefetch, a feed that yields None, a
3-D and a 2-D stack in one batch) behave as pnr_tpu's driver does."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from _torch_once import once
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.pipeline import reconstruct
from pnr_tpu_torch.pipeline import reconstruction_batch, reconstruction_func


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = PNRConfig(
    sigmas=(2.0,), somaradius=0, tolerance=10.0, znccth=0.5, kappa=2.0,
    step=2, ni=12, np=8, zdist=2.0, nodepervol=4, vol=9, wave_size=8,
    zncc_mode="tube",
)


def tube_stack(seed=0, shape=(8, 32, 64)):
    """tests/test_serve.py's stack: a modulated x-aligned tube with noise."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] // 2) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    vol = 200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
    return np.clip(vol + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


def same_result(a, b):
    """Bitwise equal trees, raw node graphs, seeds and trace counts."""
    assert a.trace_count == b.trace_count
    np.testing.assert_array_equal(a.seeds_pos, b.seeds_pos)
    np.testing.assert_array_equal(a.seeds_corr, b.seeds_corr)
    for na, nb in ((a.tree, b.tree), (a.n0, b.n0)):
        assert len(na) == len(nb)
        for f in ("x", "y", "z", "sig", "corr", "type"):
            np.testing.assert_array_equal(np.asarray(getattr(na, f)),
                                          np.asarray(getattr(nb, f)))
        assert na.nbr == nb.nbr


def batch(vols, cfg=CFG, **kw):
    return list(reconstruction_batch(vols, cfg, verbose=False, device="cpu", **kw))


@pytest.fixture(scope="module", params=["tube", "exact"])
def three(request, tmp_path_factory):
    cfg = dataclasses.replace(CFG, zncc_mode=request.param)
    vols = [tube_stack(i) for i in range(3)]
    off = once(tmp_path_factory, f"batch_three_{request.param}",
               lambda: batch(vols, cfg, prefetch=False))
    return cfg, vols, off


def test_prefetch_is_bitwise_prefetch_off(three):
    cfg, vols, off = three
    on = batch(vols, cfg, prefetch=True)
    assert len(on) == len(off) == 3
    assert any(r.trace_count > 0 for r in off)
    for a, b in zip(on, off):
        same_result(a, b)


def test_stack_i_is_reconstruction_func_with_fold_in(three):
    cfg, vols, off = three
    key = tf.key_from_seed(cfg.seed)
    for i, vol in enumerate(vols):
        one = reconstruction_func(vol, cfg, verbose=False, key=tf.fold_in(key, i), device="cpu")
        same_result(off[i], one)


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fold_in_is_jax(seed):
    import jax

    base = jax.random.key(seed)
    for i in (0, 1, 2, 3, 17, 1000):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(base, i)))
        np.testing.assert_array_equal(tf.fold_in(tf.key_from_seed(seed), i), want)


def test_empty_list_and_generator():
    assert batch([]) == []
    assert batch(iter([])) == []
    vols = [tube_stack(10), tube_stack(11)]
    off = batch(vols, prefetch=False)
    gen = batch((v for v in vols), prefetch=True)
    for a, b in zip(gen, off):
        same_result(a, b)


def test_deep_prefetch_and_a_feed_that_yields_none():
    vols = [tube_stack(20 + i) for i in range(3)]
    off = batch(vols, prefetch=False)

    def feed():
        yield None  # nothing ready yet: takes no index
        yield vols[0]
        yield None
        yield None
        yield vols[1]
        yield vols[2]
        yield None

    for got in (batch(vols, prefetch_depth=5), batch(feed()), batch(feed(), prefetch=False)):
        assert len(got) == 3
        for a, b in zip(got, off):
            same_result(a, b)


def test_3d_and_2d_stacks_use_two_trackers(monkeypatch):
    made = []
    real = reconstruct.BatchedTracker

    def counting(*a, **k):
        t = real(*a, **k)
        made.append(t.is2d)
        return t

    monkeypatch.setattr(reconstruct, "BatchedTracker", counting)
    cfg = dataclasses.replace(CFG, zdist=1.0)
    vols = [tube_stack(30), tube_stack(31, shape=(1, 32, 64)), tube_stack(32)]
    got = batch(vols, cfg, prefetch=True)
    assert sorted(made) == [False, True]
    key = tf.key_from_seed(cfg.seed)
    made.clear()
    for i, vol in enumerate(vols):
        same_result(got[i], reconstruction_func(vol, cfg, verbose=False,
                                                key=tf.fold_in(key, i), device="cpu"))


def test_worker_exception_propagates(monkeypatch):
    """A front that raises in a prefetch worker raises from the driver
    after the stacks before it: no retry without prefetch, no skip."""
    real = reconstruct._stack_front
    threads = []

    def failing(vol, *a, **k):
        threads.append(threading.current_thread().name)
        if vol.shape[1] == 40:
            raise RuntimeError("front failed")
        return real(vol, *a, **k)

    monkeypatch.setattr(reconstruct, "_stack_front", failing)
    it = reconstruction_batch([tube_stack(40), tube_stack(41, shape=(8, 40, 64))], CFG,
                              verbose=False, device="cpu")
    assert next(it).trace_count >= 0
    with pytest.raises(RuntimeError, match="front failed"):
        next(it)
    assert threads and all(t.startswith("pnr-prefetch") for t in threads)


def test_front_device_bytes():
    """What a finished front holds and its peak, per the routes' measured
    peaks (pipeline/reconstruct.py); at the main stack the model gives the
    peaks chip_smoke.py measured on the card (PERF.md, PR 9): 13 bytes a
    voxel in exact mode with and without the directions kept, 73 in tube
    mode and 76 with them; each plus the stage graphs the warm thread
    captures while the front runs, STAGE_GRAPH_BYTES for each of the two
    chunk slots a wave of 128 seeds fills."""
    shape = (128, 640, 640)
    n = 128 * 640 * 640
    g = 2 * reconstruct.STAGE_GRAPH_BYTES
    exact = dataclasses.replace(CFG, sigmas=(2.0, 4.0, 6.0), zncc_mode="exact", wave_size=128)
    held, peak = reconstruct.front_device_bytes(shape, exact)
    assert held == n + g and peak == reconstruct.FUSED_PEAK_BYTES_PER_VOXEL * n + g
    tube = dataclasses.replace(exact, zncc_mode="tube")
    held, peak = reconstruct.front_device_bytes(shape, tube)
    assert held == 36 * n + g
    assert peak == (36 + reconstruct.TUBE_BUILD_PEAK_BYTES_PER_VOXEL + 1) * n + g == 73 * n + g
    mid = dataclasses.replace(exact, save_midres=True)
    assert reconstruct.front_device_bytes(shape, mid) == (4 * n + g, 13 * n + g)
    tube_mid = dataclasses.replace(tube, save_midres=True)
    assert reconstruct.front_device_bytes(shape, tube_mid) == (39 * n + g, (73 + 3) * n + g)
    unfused = dataclasses.replace(exact, fused_frangi=False)
    assert (reconstruct.front_device_bytes(shape, unfused)[1]
            == reconstruct.UNFUSED_PEAK_BYTES_PER_VOXEL * n + g)
    # a wave of 8 seeds fills one slot
    assert (reconstruct.front_device_bytes(shape, dataclasses.replace(exact, wave_size=8))[0]
            == n + reconstruct.STAGE_GRAPH_BYTES)
