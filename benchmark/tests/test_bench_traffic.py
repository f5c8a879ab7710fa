"""The arbor generator: deterministic per (seed, index), gold on the drawn tubes."""

import numpy as np
import torch

from benchmark.tests._small import SEED, SINGLE, STACK
from benchmark.traffic import arbors


def test_same_seed_and_index_same_stack():
    a, ga = arbors.make_stack(STACK, SEED, 3, 2.0, "cpu")
    b, gb = arbors.make_stack(STACK, SEED, 3, 2.0, "cpu")
    assert torch.equal(a, b) and np.array_equal(ga, gb)
    c, gc = arbors.make_stack(STACK, SEED, 4, 2.0, "cpu")
    d, gd = arbors.make_stack(STACK, SEED + 1, 3, 2.0, "cpu")
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert a.dtype == torch.uint8 and tuple(a.shape) == tuple(STACK["shape"])


def test_gold_lies_on_the_drawn_centerlines():
    vol, gold = arbors.make_stack(STACK, SEED, 0, 2.0, "cpu")
    v = vol.numpy().astype(float)
    x, y, z = (np.rint(gold[:, k]).astype(int) for k in (2, 3, 4))
    on = v[z, y, x]
    # the tube's peak (>= 120 * 0.5 after modulation) against background 10, noise sd 5
    assert np.median(on) > 60 and np.median(v) < 20
    assert on.min() > 30
    shape = STACK["shape"]
    assert (x >= 0).all() and (x < shape[2]).all() and (z >= 0).all() and (z < shape[0]).all()


def test_gold_is_a_tree_sampled_every_voxel():
    _, gold = arbors.arbor_geometry(SINGLE["stack"], SEED, 0, 2.0)
    ids, par = gold[:, 0].astype(int), gold[:, 6].astype(int)
    assert (ids == np.arange(1, len(gold) + 1)).all()
    assert (par < ids).all() and ((par == -1) | (par >= 1)).all()
    assert int((par == -1).sum()) == SINGLE["stack"]["arbors"]
    pos = {int(r[0]): r[2:5] for r in gold}
    steps = np.array([np.linalg.norm((pos[i] - pos[p]) * [1, 1, 2.0]) for i, p in zip(ids, par) if p > 0])
    assert 0.9 < steps.min() and steps.max() < 1.1
    # 4 arbors of 7 segments of 100-180 voxels
    assert 4 * 7 * 100 <= len(gold) <= 4 * 7 * 180 + 4


def test_pool_is_on_the_host_and_distinct():
    vols, golds = arbors.make_pool(STACK, SEED, 3, 2.0, "cpu")
    assert all(isinstance(v, np.ndarray) and v.dtype == np.uint8 for v in vols)
    assert not np.array_equal(vols[0], vols[1]) and len(golds) == 3
