"""The slab decomposition of K2's cluster kernel (csrc/zncc_exact.cu), on
the CPU.

The kernel cuts each trace's patch into z slabs (`slab_plan`): a block
samples only the template rows whose floor z1 its slab owns, and the
cluster adds the blocks' partial sums in rank order. Here the plain sums
(`exact_sums_plain`, the specification) are split by that ownership rule
and added in that order, and must equal the undivided sums; the slab plans
must cover the patch and respect the budget; and the (w, v, u) order of
the template rows must give the sums of the lattice's own order. The
kernel itself is held to the plain sums on a card
(tests/test_torch_kernels.py). The plain sums stay at sigmas (2, 3) but
for one small case at (2, 4, 6).
"""

import numpy as np
import pytest
import torch

from _torch_cases import STEP, ZNCC_VOLUMES, queries
from pnr_tpu_torch.ops import zncc_exact
from pnr_tpu_torch.ops.zncc_exact import (
    ExactPatchEngine,
    ZnccTemplates,
    exact_sums_plain,
    kernel_plan,
    plain_samples,
    row_pitch,
    slab_plan,
    smem_bytes,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the kernel's cluster size limit (csrc/zncc_exact.cu: kMaxCluster)
MAX_CLUSTER = 8


@pytest.mark.parametrize("px", [2, 3, 4, 5, 30, 48, 50, 82, 130])
def test_row_pitch_holds_a_row_from_its_aligned_word(px):
    """A row copied from the 4-byte word at or below its first byte (up to
    3 bytes earlier) fits, in whole words and no more."""
    pitch = row_pitch(px)
    assert pitch % 4 == 0 and px + 3 <= pitch < px + 7


def check_plan(patch, budget, plan):
    pz, py, px = patch
    bounds = plan.bounds(pz)
    assert len(bounds) == plan.nz
    # ownership: the floors 0 .. pz-2, each exactly once, in order, none empty
    owned = [z for lo, hi in bounds for z in range(lo, hi)]
    assert owned == list(range(pz - 1))
    assert all(hi > lo for lo, hi in bounds)
    # each slab holds its floors and one plane more; neighbours share one plane
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2
    assert bounds[-1][1] == pz - 1
    # the largest slab fits the budget
    assert (plan.step + 1) * py * plan.pitch <= budget
    assert max(hi - lo for lo, hi in bounds) == plan.step


@pytest.mark.parametrize("patch,budget,nz", [
    ((38, 56, 50), 220_000, 1),  # sigmas (2, 3), step 2: the whole patch
    ((56, 88, 82), 226_000, 2),  # sigmas (2, 4, 6), step 2
    ((56, 88, 82), 100_000, 5),
    ((20, 48, 48), 3 * 48 * 52, 10),  # three planes a slab: more than a cluster
    ((24, 20, 30), 8 * 20 * 36, 4),
    ((2, 2, 2), 1_000, 1),
])
def test_slab_plan_covers_the_patch_within_the_budget(patch, budget, nz):
    plan = slab_plan(patch, budget)
    assert plan.nz == nz
    check_plan(patch, budget, plan)


def test_slab_plan_sweep():
    for pz in range(2, 70, 3):
        for planes in range(2, pz + 3):
            budget = planes * 9 * row_pitch(13)
            plan = slab_plan((pz, 9, 13), budget)
            check_plan((pz, 9, 13), budget, plan)
            # the fewest slabs the budget allows
            assert plan.nz == -(-(pz - 1) // (planes - 1))


@pytest.mark.parametrize("py", [2, 3, 17, 64])
@pytest.mark.parametrize("px", [2, 3, 17, 64])
def test_slab_plan_of_one_plane(py, px):
    """A one-plane patch (a 2-D stack) is one slab of one plane, step 0,
    owning floor 0; its shared memory is the plane."""
    plan = slab_plan((1, py, px), 232_448)
    assert (plan.nz, plan.step, plan.pitch) == (1, 0, row_pitch(px))
    assert plan.bounds(1) == [(0, 1)]
    kp = kernel_plan((1, py, px), 20, 3)
    assert (kp.nz, kp.step) == (1, 0)
    assert smem_bytes(kp, py, 20, 3) == (-(-py * kp.pitch // 16) * 16 + zncc_exact._RED_BYTES
                                        + 12 * 20 * 3 + 4 * 16 * 20)


def test_slab_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match=">= 2"):
        slab_plan((8, 1, 8), 10_000)
    with pytest.raises(ValueError, match=">= 2"):
        slab_plan((8, 8, 1), 10_000)
    with pytest.raises(ValueError, match=">= 2"):
        slab_plan((1, 8, 1), 10_000)
    with pytest.raises(ValueError, match="plane of the patch"):
        slab_plan((1, 8, 8), 8 * 12 - 1)
    with pytest.raises(ValueError, match="two planes"):
        slab_plan((8, 8, 8), 2 * 8 * 12 - 1)


def test_kernel_plan_fits_shared_memory():
    """The main configuration (sigmas (2, 4, 6), step 2, a 20-particle
    tracer and the one-query estimate) takes two slabs a trace, sigmas
    (2, 3) one; the block's shared memory stays within the card's."""
    main = ExactPatchEngine(ZnccTemplates((2.0, 4.0, 6.0), False), STEP, "cpu")
    small = ExactPatchEngine(ZnccTemplates((2.0, 3.0), False), STEP, "cpu")
    dims = main.dims((128, 640, 640))
    assert dims == (56, 88, 82) and small.dims((128, 640, 640)) == (38, 56, 50)
    for b in (1, 20):
        plan = kernel_plan(dims, b, 3)
        assert plan.nz == 2
        assert smem_bytes(plan, dims[1], b, 3) <= zncc_exact.SMEM_MAX
    # many queries a trace: their sums take room from the slab
    plan = kernel_plan(dims, 200, 3)
    assert plan.nz == 3 and smem_bytes(plan, dims[1], 200, 3) <= zncc_exact.SMEM_MAX
    assert kernel_plan((38, 56, 50), 20, 2).nz == 1


def slab_partials(vol, corner, qs, tables, patch, plan):
    """The plain sums split by the kernel's ownership rule: (nz, T, B, S, 4)
    partials, slab i summing the samples whose floor(rz) it owns."""
    t, b = int(qs.shape[0]), int(qs.shape[1])
    out = torch.zeros((plan.nz, t, b, int(tables.tab.shape[0]), 4))
    for si, t0, vals, rz, tg in plain_samples(vol, corner, qs, tables, patch):
        z1 = torch.floor(rz)
        n = vals.shape[0]
        for i, (lo, hi) in enumerate(plan.bounds(patch[0])):
            v = torch.where((z1 >= lo) & (z1 < hi), vals, torch.zeros_like(vals))
            out[i, t0 : t0 + n, :, si, 0] = v.sum(-1)
            out[i, t0 : t0 + n, :, si, 1] = (v * v).sum(-1)
            out[i, t0 : t0 + n, :, si, 2] = (v * tg).sum(-1)
    return out


def cluster_sum(parts):
    """The kernel's order: block r adds slabs r, r + 8, ... in turn, then
    block 0 adds the blocks' sums in rank order."""
    nz = parts.shape[0]
    blocks = []
    for r in range(min(nz, MAX_CLUSTER)):
        acc = parts[r].clone()
        for i in range(r + MAX_CLUSTER, nz, MAX_CLUSTER):
            acc += parts[i]
        blocks.append(acc)
    total = blocks[0].clone()
    for blk in blocks[1:]:
        total += blk
    return total


def exact_inputs(vol_name, sigmas, b=20, t=8):
    vol = torch.from_numpy(ZNCC_VOLUMES[vol_name]())
    pos, d = queries(tuple(vol.shape), t=t)
    eng = ExactPatchEngine(ZnccTemplates(sigmas, False), STEP, "cpu")
    pos, d = torch.from_numpy(pos[:, :b]), torch.from_numpy(d[:, :b])
    corner = eng.corners(vol.shape, pos.mean(dim=1))
    return vol, corner, eng.qinfo(vol, corner, pos, d), eng


def check_columns(got, want, rtol):
    for i in range(3):
        scale = max(float(want[..., i].abs().max()), 1.0)
        assert float((got[..., i] - want[..., i]).abs().max()) <= rtol * scale
    assert bool((got[..., 3] == 0).all())


@pytest.mark.parametrize("nz", [2, 3, "many"])
@pytest.mark.parametrize("vol_name", list(ZNCC_VOLUMES))
def test_slab_partials_in_rank_order_equal_the_plain_sums(vol_name, nz):
    vol, corner, qs, eng = exact_inputs(vol_name, (2.0, 3.0))
    patch = eng.dims(vol.shape)
    pz, py, px = patch
    planes = 3 if nz == "many" else -(-(pz - 1) // nz) + 1
    plan = slab_plan(patch, planes * py * row_pitch(px))
    assert plan.nz > MAX_CLUSTER if nz == "many" else plan.nz == nz
    parts = slab_partials(vol, corner, qs, eng.tables, patch, plan)
    want = exact_sums_plain(vol, corner, qs, eng.tables, patch)
    check_columns(cluster_sum(parts), want, 1e-6)


def test_slab_partials_at_the_main_sigmas():
    """Sigmas (2, 4, 6) at a tiny T x B, two slabs as on the card."""
    vol, corner, qs, eng = exact_inputs("tube", (2.0, 4.0, 6.0), b=2, t=2)
    patch = eng.dims(vol.shape)
    plan = slab_plan(patch, (-(-(patch[0] - 1) // 2) + 1) * patch[1] * row_pitch(patch[2]))
    assert plan.nz == 2
    parts = slab_partials(vol, corner, qs, eng.tables, patch, plan)
    check_columns(cluster_sum(parts), exact_sums_plain(vol, corner, qs, eng.tables, patch), 1e-6)


def test_every_sample_is_owned_once():
    """Counting samples instead of summing them: each (query, sigma) row
    count is split over the slabs with nothing lost or doubled."""
    vol, corner, qs, eng = exact_inputs("flat", (2.0, 3.0))
    patch = eng.dims(vol.shape)
    plan = slab_plan(patch, 4 * patch[1] * row_pitch(patch[2]))
    assert plan.nz >= 3
    counts = np.zeros((plan.nz,))
    total = 0
    for si, t0, vals, rz, tg in plain_samples(vol, corner, qs, eng.tables, patch):
        z1 = torch.floor(rz).expand_as(vals)
        assert float(z1.min()) >= 0 and float(z1.max()) <= patch[0] - 2
        total += vals.numel()
        for i, (lo, hi) in enumerate(plan.bounds(patch[0])):
            counts[i] += int(((z1 >= lo) & (z1 < hi)).sum())
    assert counts.sum() == total


@pytest.mark.parametrize("vol_name", list(ZNCC_VOLUMES))
def test_sorted_table_gives_the_lattice_order_sums(vol_name):
    """The (w, v, u) order of `template_tables` against the lattice's own
    (v, u, w) order of `ZnccTemplates`."""
    vol, corner, qs, eng = exact_inputs(vol_name, (2.0, 3.0))
    tmpl = ZnccTemplates((2.0, 3.0), False)
    lattice = np.concatenate([tmpl.offs, tmpl.wgt[..., None]], axis=-1).astype(np.float32)
    sorted_tab = eng.tables.tab.numpy()
    for i in range(2):
        k = int(tmpl.cnt[i])
        assert not np.array_equal(sorted_tab[i, :k], lattice[i, :k])
        # the same rows, w outermost and u innermost
        assert sorted(map(tuple, sorted_tab[i, :k])) == sorted(map(tuple, lattice[i, :k]))
        w, v = sorted_tab[i, :k, 2], sorted_tab[i, :k, 0]
        assert np.all(np.diff(w) >= 0)
        assert np.all((np.diff(w) > 0) | (np.diff(v) >= 0))
    patch = eng.dims(vol.shape)
    got = exact_sums_plain(vol, corner, qs, eng.tables, patch)
    want = exact_sums_plain(vol, corner, qs, eng.tables._replace(tab=torch.from_numpy(lattice)),
                            patch)
    check_columns(got, want, 1e-6)
