"""The launch plans of K1 and K3 (pnr_tpu_torch/ops/frangi_fused.py,
pnr_tpu_torch/ops/conv.py), checked on the CPU.

K1 runs one block per (y tile, x tile) column of the stack, walking z with
a ring of 2hz + 1 xy-smoothed planes and a ring of 5 planes of F in shared
memory; `fused_plan` sizes its tile so that the rings fit one block, and
`ring_schedule` is the order in which a block fills and reads them. K3's
`conv1d_plan` is its grid: a thread owns a run of outputs along z or y (a
register window of inputs), or four x outputs of a warp's row segment.
These tests hold the plans to what the kernels need: the shared memory
fits, every output voxel is formed by exactly one block or thread, and
each block's window and rings hold every input its outputs read. The C
side's own sums are held to these in tests/test_torch_kernels.py.
"""

import itertools

import numpy as np
import pytest
import torch

from pnr_tpu_torch.ops import conv, frangi_fused
from pnr_tpu_torch.ops.frangi_fused import (
    F_RING,
    SMEM_LIMIT,
    block_window,
    fused_plan,
    ring_schedule,
)
from pnr_tpu_torch.ops.gaussian import gaussian_kernel
from pnr_tpu_torch.ops.zncc_model import TubeZnccModel

ZDISTS = (0.5, 1.0, 2.0, 5.0)
SIGMA_SWEEP = tuple(np.round(np.arange(0.5, 21.0001, 0.25), 2))


@pytest.mark.parametrize("zdist", ZDISTS)
def test_k1_plan_fits_shared_memory_across_sigmas(zdist):
    for sigma in SIGMA_SWEEP:
        plan = fused_plan((128, 640, 640), sigma, zdist)
        assert plan.smem <= SMEM_LIMIT
        assert plan.smem == frangi_fused.smem_bytes(plan.tile_y, plan.tile_x, plan.hxy, plan.hz)
        assert (plan.ring_g, plan.ring_f) == (2 * plan.hz + 1, F_RING)
        # the half-widths are those of the taps the wrapper passes
        assert 2 * plan.hxy + 1 == len(gaussian_kernel(sigma))
        assert 2 * plan.hz + 1 == len(gaussian_kernel(sigma / zdist))
        # no tile that fits finishes sooner on 132 SMs
        cost = -(-plan.grid[0] * plan.grid[1] // 132) * frangi_fused.block_cost(
            plan.tile_y, plan.tile_x, plan.hxy, plan.hz)
        for ty, tx in frangi_fused.TILES:
            if frangi_fused.smem_bytes(ty, tx, plan.hxy, plan.hz) <= SMEM_LIMIT:
                blocks = -(-640 // ty) * -(-640 // tx)
                assert cost <= -(-blocks // 132) * frangi_fused.block_cost(ty, tx, plan.hxy,
                                                                           plan.hz)


def test_k1_plan_at_the_main_sigmas():
    # 40 x 40 tiles: 256 blocks, two rounds on 132 SMs (32 x 32: 400, four)
    for sigma in (2.0, 4.0, 6.0):
        plan = fused_plan((128, 640, 640), sigma, 2.0)
        assert (plan.tile_y, plan.tile_x, plan.grid) == (40, 40, (16, 16))
    # sigma 6 at zdist 2: 19 z taps, ~213 KB a block
    assert fused_plan((128, 640, 640), 6.0, 2.0).smem == 218192
    # on 144 SMs 400 blocks of 32 x 32 take three rounds and win
    assert fused_plan((128, 640, 640), 2.0, 2.0, sms=144)[2:4] == (32, 32)


def test_k1_plan_raises_with_the_shapes():
    with pytest.raises(ValueError, match="133"):
        fused_plan((16, 64, 64), 22.0, 2.0)
    with pytest.raises(ValueError, match=r"sigma 21.0 at zdist 0.2"):
        fused_plan((16, 64, 64), 21.0, 0.2)


#: (shape, sigma, zdist): Z below 2hz + 1, dimensions of 2, Y and X not
#: multiples of the tile, a tile that the rings shrink
PLAN_CASES = {
    "build_stack": ((8, 24, 24), 2.0, 2.0),
    "z_below_ring": ((6, 40, 44), 6.0, 2.0),
    "z2": ((2, 40, 44), 3.0, 1.0),
    "y2": ((12, 2, 70), 2.0, 2.0),
    "x2": ((12, 70, 2), 2.0, 2.0),
    "odd": ((10, 37, 53), 2.0, 2.0),
    "ragged_tiles": ((9, 70, 100), 4.0, 2.0),
    "small_tile": ((30, 50, 70), 6.0, 0.5),
    "main_sigma6": ((128, 640, 640), 6.0, 2.0),
}


def _clamped(lo, hi, n):
    return max(lo, 0), min(hi, n - 1)


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_k1_blocks_own_each_voxel_once_and_cover_their_reach(case):
    shape, sigma, zdist = PLAN_CASES[case]
    z, y, x = shape
    plan = fused_plan(shape, sigma, zdist)
    owner = np.zeros((y, x), np.int32)
    reach = plan.hxy + 2
    for by, bx in itertools.product(range(plan.grid[0]), range(plan.grid[1])):
        w = block_window(plan, shape, by, bx)
        assert w.out_y[0] < w.out_y[1] and w.out_x[0] < w.out_x[1]
        owner[w.out_y[0]:w.out_y[1], w.out_x[0]:w.out_x[1]] += 1
        # the clamped reach of the block's first and last outputs (and so
        # of every output between them) lies inside its window
        for yy in (w.out_y[0], w.out_y[1] - 1):
            lo, hi = _clamped(yy - reach, yy + reach, y)
            assert w.win_y[0] <= lo and hi < w.win_y[1]
        for xx in (w.out_x[0], w.out_x[1] - 1):
            lo, hi = _clamped(xx - reach, xx + reach, x)
            assert w.win_x[0] <= lo and hi < w.win_x[1]
        assert w.win_y[1] - w.win_y[0] <= plan.tile_y + 2 * reach
        assert w.win_x[1] - w.win_x[0] <= plan.tile_x + 2 * reach
    assert (owner == 1).all()


def _simulate_rings(z, hz):
    """Walk `ring_schedule` with the kernel's slots (G plane p in slot
    p mod 2hz + 1, F plane p in slot p mod 5) and check that every read
    finds its plane; returns the planes formed and finished, in order."""
    depth = 2 * hz + 1
    g_ring, f_ring = [None] * depth, [None] * F_RING
    made_g, made_f, done = [], [], []
    for step in ring_schedule(z, hz):
        if step.g is not None:
            g_ring[step.g % depth] = step.g
            made_g.append(step.g)
        if step.f is not None:
            for t in range(depth):
                p = min(max(step.f + t - hz, 0), z - 1)
                assert g_ring[p % depth] == p, (step, p)
            f_ring[step.f % F_RING] = step.f
            made_f.append(step.f)
        if step.out is not None:
            # the planes grad2 reads along z: zo - 2 .. zo + 2, clamped
            for p in range(max(step.out - 2, 0), min(step.out + 2, z - 1) + 1):
                assert f_ring[p % F_RING] == p, (step, p)
            done.append(step.out)
    return made_g, made_f, done


@pytest.mark.parametrize("zdist", ZDISTS)
@pytest.mark.parametrize("z", [2, 3, 5, 8, 19, 40])
def test_k1_rings_hold_every_plane_a_step_reads(z, zdist):
    for sigma in (0.5, 2.0, 6.0, 21.0):
        hz = fused_plan((z, 16, 16), sigma, zdist).hz
        made_g, made_f, done = _simulate_rings(z, hz)
        # each plane is smoothed, convolved in z and finished exactly once
        assert made_g == made_f == done == list(range(z))


def test_k1_schedule_at_the_main_stack():
    steps = ring_schedule(128, 9)
    assert len(steps) == 128 + 9 + 2
    assert steps[0] == (0, None, None) and steps[11] == (11, 2, 0)
    assert steps[-1] == (None, None, 127)


#: (shape, taps): X a multiple of 4 (four columns a thread) or not, a
#: length along the axis that is no multiple of the run, 1 to 127 taps
CONV_PLAN_CASES = {
    "vec4": ((13, 20, 64), 3),
    "odd_x": ((11, 9, 37), 19),
    "long_taps_vec4": ((9, 12, 136), 127),
    "one_tap": ((5, 7, 130), 1),
    "tiny": ((2, 2, 2), 37),
}


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("case", list(CONV_PLAN_CASES))
def test_k3_threads_own_each_output_once_and_read_their_reach(case, axis):
    shape, ntaps = CONV_PLAN_CASES[case]
    vec4 = shape[2] % 4 == 0
    plan = conv.conv1d_plan(shape, axis, ntaps, vec4)
    assert plan.ok
    assert plan.vec == (4 if vec4 and axis != 2 else 1)
    owner = np.zeros(shape, np.int32)
    half, n = ntaps // 2, shape[axis]
    gx, gy, gz = plan.grid
    bx_, by_, _ = plan.block
    for b in itertools.product(range(gx), range(gy), range(gz)):
        for t in itertools.product(range(bx_), range(by_)):
            outs = conv.thread_outputs(plan, shape, axis, b, t)
            if not outs:
                continue
            reads = conv.thread_reads(plan, n, axis, ntaps, b, t)
            for o in outs:
                owner[o] += 1
                p = o[axis]
                assert reads.start <= p - half and p + half < reads.stop
    assert (owner == 1).all()


def test_k3_plan_shared_memory_and_limits():
    plan = conv.conv1d_plan((128, 640, 640), 2, 127, True)
    assert plan.smem == conv.ROWS * (conv.ROW_SEG + 128) * 4 and plan.smem <= 48 * 1024
    assert conv.conv1d_plan((128, 640, 640), 0, 19, True).grid == (16, 5, 160)
    assert conv.conv1d_plan((128, 640, 640), 1, 3, False).grid == (80, 20, 32)
    assert not conv.conv1d_plan((4, 70000, 70000), 0, 3, True).ok


def test_map_build_kernels_fit_k3():
    """Every 1-D kernel of the tube map build is an odd number of taps
    within K3's 127; a longer one raises with its size."""
    for sigmas in ((2.0, 3.0), (2.0, 4.0, 6.0), (8.0, 12.0, 16.0)):
        model = TubeZnccModel(sigmas, False)
        for i in range(len(sigmas)):
            for k in (model.gauss_kernels[i], np.ones(2 * model.box_half[i] + 1, np.float32)):
                assert k.size % 2 == 1 and k.size <= conv.MAX_TAPS
                assert conv._taps(k, "conv1d_along_axis").size == k.size
    with pytest.raises(ValueError, match="conv1d_along_axis.*got 129"):
        conv._taps(np.ones(129, np.float32), "conv1d_along_axis")


def test_cpu_tensor_takes_k1s_plain_version_for_any_sigma():
    """The plan is the CUDA route's: a CPU tensor runs the plain chain
    even where no tile would fit."""
    vol = torch.from_numpy((np.random.default_rng(0).random((4, 6, 6)) * 255).astype(np.uint8))
    n = frangi_fused.LAUNCHES
    out = frangi_fused.frangi3d_fused(vol, (22.0,), 2.0)
    assert frangi_fused.LAUNCHES == n and out[0].shape == vol.shape


def test_fused_cap_is_the_filter_stages_peak():
    """K1's cap is 60 GB over the filter stage's measured peak: K1 then
    `normalize_to_u8`, 12 bytes per voxel above the uint8 stack, so 13 with
    it (chip_smoke.py's [unfused] peaks, PERF.md)."""
    from pnr_tpu_torch.pipeline import reconstruct

    assert reconstruct.FUSED_PEAK_BYTES_PER_VOXEL == 13
    assert reconstruct.FUSED_MAX_VOXELS == reconstruct.FRANGI_BUDGET_BYTES // 13
    assert 4.6e9 < reconstruct.FUSED_MAX_VOXELS < 4.7e9
    assert reconstruct.UNFUSED_MAX_VOXELS < reconstruct.FUSED_MAX_VOXELS
