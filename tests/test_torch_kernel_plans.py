"""The launch plans of K1, K3 and K4 (pnr_tpu_torch/ops/frangi_fused.py,
pnr_tpu_torch/ops/conv.py), checked on the CPU.

K1 runs one block per (y tile, x tile) column of the stack, walking z with
a ring of 2hz + 1 xy-smoothed planes and a ring of 5 planes of F in shared
memory; `fused_plan` sizes its tile so that the rings fit one block, and
`ring_schedule` is the order in which a block fills and reads them. K3's
`conv1d_plan` is its grid: a thread owns a run of outputs along z or y (a
register window of inputs), or four x outputs of a warp's row segment.
K4's `conv_yx_plan` is its grid and its block's shared memory; the block
walks a column of y tiles and stages their input rows into a ring, 16-byte
chunks at a time (`yx_walk`),
its threads form y-pass runs down the window's columns (`yx_y_items`) and
eight x outputs a lane (`yx_x_outputs`); the tests simulate a block's
walk byte by byte and its two passes from what it staged.
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
    # one plane (a 2-D stack): the soma and 2-D Gaussians and the 2-D map
    # build run K3 along y and x only
    "one_plane_vec4": ((1, 40, 64), 25),
    "one_plane_odd": ((1, 23, 37), 13),
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


def test_k3_plan_of_a_4096_plane():
    """The 2-D main stack's plane (1, 4096, 4096): y and x grids within
    the card's limits, one z block."""
    y = conv.conv1d_plan((1, 4096, 4096), 1, 25, True)
    x = conv.conv1d_plan((1, 4096, 4096), 2, 25, True)
    assert y.ok and x.ok
    assert y.grid == (512, 32, 1) and x.grid == (32, 512, 1)


def test_tube_corr_takes_one_plane_windows_only_on_a_one_plane_volume():
    """`KernelParams` accepts pz = 1 where the volume has one plane (the
    2-D tube engine's windows) and refuses it on a 3-D volume, and
    refuses py or px under 2 on either."""
    from pnr_tpu_torch.ops import tube_corr as tc
    from pnr_tpu_torch.ops.zncc_fast import TubePatchEngine

    eng = TubePatchEngine(TubeZnccModel((2.0, 4.0, 6.0), True), 2.0, 1.0, device="cpu")
    plane = (1, 4096, 4096)
    groups = eng.groups(plane)
    assert all(g[2][0] == 1 for g in groups) and eng.dims(plane)[0] == 1
    p = tc.KernelParams(eng.tables, groups, plane, "cpu")
    assert [tuple(p.struct.win[g])[0] for g in range(len(groups))] == [1] * len(groups)
    assert p.field_shape == (3, 1, 4096, 3 * 4096)
    with pytest.raises(ValueError, match="one-plane"):
        tc.KernelParams(eng.tables, [(0, 3, (1, 24, 24))], (8, 64, 64), "cpu")
    for bad in ((1, 1, 24), (1, 24, 1)):
        with pytest.raises(ValueError, match=">= 2"):
            tc.KernelParams(eng.tables, [(0, 3, bad)], plane, "cpu")


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


#: (shape, y taps, x taps, uint8): the main stack at sigma 6, ragged
#: shapes (a plane smaller than one tile, Y and X no multiple of the tile,
#: X no multiple of 4 or 16), 1 to 127 taps, and a tall plane whose
#: blocks walk many tiles around their ring
YX_CASES = {
    "main_sigma6_u8": ((128, 640, 640), 37, 37, True),
    "tiny_u8": ((2, 5, 7), 13, 13, True),
    "tiny_f32": ((2, 5, 7), 25, 3, False),
    "ragged_u8": ((3, 70, 150), 37, 37, True),
    "ragged_f32": ((3, 70, 150), 13, 25, False),
    "x136_f32": ((6, 40, 136), 25, 13, False),
    "x136_u8": ((6, 40, 136), 1, 37, True),
    "row_u8_127": ((1, 1, 130), 127, 127, True),
    "row_f32_127": ((1, 1, 130), 127, 127, False),
    "tall_u8": ((2, 300, 130), 25, 13, True),
}


@pytest.mark.parametrize("u8", [True, False])
def test_k4_plan_fits_shared_memory_across_sigmas(u8):
    """At every sigma from 0.5 to 21 K4's block fits the card's shared
    memory; from uint8 (the filter's input) four blocks share an SM."""
    for sigma in SIGMA_SWEEP:
        n = len(gaussian_kernel(sigma))
        plan = conv.conv_yx_plan((128, 640, 640), n, n, u8)
        g = plan.geom
        assert plan.ok and plan.smem == g.smem <= conv.SMEM_LIMIT
        assert plan.smem == conv.yx_geom(n, n, 1 if u8 else 4, plan.ty).smem
        assert plan.ty in conv.YX_TILE_YS and plan.ty % conv.YX_RUN == 0
        # the tallest tile whose block lets four share an SM, else the last
        fits = [ty for ty in conv.YX_TILE_YS
                if conv.yx_geom(n, n, 1 if u8 else 4, ty).smem <= conv.SMEM_LIMIT // 4]
        assert plan.ty == (fits[0] if fits else conv.YX_TILE_YS[-1])
        if u8:
            # several blocks an SM: four up to sigma 16, three to sigma 21
            assert (4 if sigma <= 16 else 3) * plan.smem <= conv.SMEM_LIMIT
        assert (plan.tx, plan.run, plan.block) == (128, 16, (256, 1, 1))
        assert g.rows % 4 == 0 and g.pitch % 16 == 0 and g.margin % 16 == 0 and g.tmpw % 4 == 0
        # the ring holds a window and the next tile's rows, and the rows
        # the register window reads past the window map to distinct slots
        assert g.nring == 2 * plan.ty + n - 1 >= g.rows


def test_k4_plan_at_the_main_shape():
    # sigmas 2, 4, 6 from uint8 (13, 25, 37 taps): 32-row tiles, a block
    # walks 5 of a column's 20 (2,560 blocks)
    assert [conv.conv_yx_plan((128, 640, 640), n, n, True)[:7] for n in (13, 25, 37)] == [
        ((5, 4, 128), (256, 1, 1), 32432, 32, 128, 16, True),
        ((5, 4, 128), (256, 1, 1), 37680, 32, 128, 16, True),
        ((5, 4, 128), (256, 1, 1), 44912, 32, 128, 16, True)]
    assert conv.conv_yx_plan((128, 640, 640), 37, 37, True).tiles == 5
    # a tile of the tiled engines: walks of 2
    plan = conv.conv_yx_plan((55, 640, 640), 37, 37, True)
    assert (plan.grid, plan.tiles) == ((5, 10, 55), 2)
    assert conv.conv_yx_plan((2, 5, 7), 37, 37, True).tiles == 1
    assert not conv.conv_yx_plan((65536, 1, 1), 3, 3, True).ok
    # a tall plane: the walks keep the grid's y within 65535 blocks
    plan = conv.conv_yx_plan((1, 65536 * 32 + 1, 1), 13, 13, True)
    assert plan.ok and plan.grid[1] <= 65535 < -(-(65536 * 32 + 1) // plan.ty)


def test_k4_plan_raises_with_the_shapes():
    with pytest.raises(ValueError, match=r"\(128, 640, 640\) volume with 129 y and 37 x taps"):
        conv.conv_yx_plan((128, 640, 640), 129, 37, True)
    with pytest.raises(ValueError, match=r"\(4, 8, 8\) volume with 3 y and 4 x taps"):
        conv.conv_yx_plan((4, 8, 8), 3, 4, False)
    with pytest.raises(ValueError, match="odd number of taps <= 127"):
        conv.conv_yx_plan((4, 8, 8), 0, 3, True)


@pytest.mark.parametrize("blocks", [conv.YX_BLOCKS, 1])
@pytest.mark.parametrize("case", list(YX_CASES))
def test_k4_threads_own_each_output_once(case, blocks):
    """Every output voxel is formed by exactly one (block, step of its
    walk, thread) of the x pass, and the y pass's items cover each (window
    column, run) of a tile exactly once."""
    shape, nky, nkx, u8 = YX_CASES[case]
    plan = conv.conv_yx_plan(shape, nky, nkx, u8, blocks)
    assert plan.ok and plan.grid[2] == shape[0]
    assert (plan.grid[1] - 1) * plan.tiles < -(-shape[1] // plan.ty) <= plan.grid[1] * plan.tiles
    g = plan.geom
    items = [it for t in range(plan.block[0]) for it in conv.yx_y_items(plan, t)]
    assert sorted(items) == [(c, r0) for c in range(g.ncols) for r0 in range(0, g.ty, conv.YX_RUN)]
    zs = min(shape[0], 2)
    owner = np.zeros((zs,) + tuple(shape[1:]), np.int32)
    gx, gy, _ = plan.grid
    # the blocks of two z planes: z only offsets a block's plane
    for b in itertools.product(range(gx), range(gy), range(zs)):
        for t in range(plan.block[0]):
            for z, y, x, k, r in conv.yx_x_outputs(plan, shape, b, t):
                assert y == (b[1] * plan.tiles + k) * plan.ty + r
                assert 0 <= x - b[0] * plan.tx < plan.tx
                owner[z, y, x] += 1
    assert (owner == 1).all()


def _round_up16(v):
    return (v + 15) & ~15


def _walk_block(plan, vol, nky, nkx, base, b, mem, lo):
    """A K4 block's walk as the kernel takes it, on a simulated device
    memory `mem` (the volume's bytes at address `base`, `lo` the address
    of mem[0]) and a shared-memory byte array for the ring: the first
    window's copies, then each step's copies of the next tile's rows (made
    to land at once, before the step reads its window, so that a slot the
    step still reads would be caught), the edge fill of the rows that
    landed for it and its window read through the row slots. Yields (y0,
    window) per step, the window being the staged rows x ncols; checks that
    every copy and read stays in its slot and in the volume's chunks."""
    g = plan.geom
    size = vol.itemsize
    ring = np.full(g.nring * g.pitch, 0xA5, np.uint8)
    slotoff = np.full(g.nring, -1)
    nleft, clast, init, first, steps = conv.yx_walk(plan, vol.shape, nky, nkx, size, base, b)
    for slot, off in init:
        slotoff[slot] = off

    def copy(copies):
        for slot, dst, src, nch, off in copies:
            assert dst == slot * g.pitch + g.margin and dst + 16 * nch <= (slot + 1) * g.pitch
            # whole aligned chunks that never leave the volume's first and last
            assert src % 16 == 0 and lo <= src and src + 16 * nch <= lo + mem.size
            ring[dst: dst + 16 * nch] = mem[src - lo: src - lo + 16 * nch]
            slotoff[slot] = off

    copy(first)
    staged = g.ty + nky - 1
    for y0, copies, landed, rowslot in steps:
        copy(copies)
        for slot in landed:
            row = ring[slotoff[slot]: slotoff[slot] + g.ncols * size].view(vol.dtype)
            row[:nleft] = row[nleft]
            row[clast + 1:] = row[clast]
        assert len(rowslot) == g.rows and len(set(rowslot)) == g.rows
        assert not set(rowslot[:staged]) & {c[0] for c in copies}
        for slot in rowslot:
            off = slotoff[slot]
            assert off % size == 0 and slot * g.pitch <= off
            assert off + g.ncols * size <= (slot + 1) * g.pitch
        yield y0, np.stack([ring[slotoff[s]: slotoff[s] + g.ncols * size].view(vol.dtype)
                            for s in rowslot[:staged]])


@pytest.mark.parametrize("blocks", [conv.YX_BLOCKS, 1])
@pytest.mark.parametrize("case", [c for c in YX_CASES if not c.startswith("main")])
@pytest.mark.parametrize("lead", [0, 1, 2, 3])
def test_k4_blocks_stage_and_read_exactly_their_clamped_window(case, lead, blocks):
    """Each block stages, tile by tile of its walk, the edge-clamped window
    that its taps reach, for a volume at any alignment (uint8 rows at any
    byte, float32 at any word); each y-pass run and x lane reads within its
    buffers, and the two passes computed from what was staged (float64,
    the kernel's items and lanes) give the edge-replicated y-then-x
    correlation."""
    shape, nky, nkx, u8 = YX_CASES[case]
    # the first element's address mod 16: any byte for uint8, any word for float32
    lead = (0, 1, 7, 13)[lead] if u8 else 4 * lead
    rng = np.random.default_rng(5)
    vol = rng.integers(0, 256, shape).astype(np.uint8 if u8 else np.float32)
    ky, kx = rng.random(nky), rng.random(nkx)
    plan = conv.conv_yx_plan(shape, nky, nkx, u8, blocks)
    g = plan.geom
    gy4 = 4 * -(-nky // 4)
    # reference: edge-replicated y then x correlation in float64
    v = vol.astype(np.float64)
    yi = np.clip(np.arange(shape[1])[:, None] + np.arange(nky) - nky // 2, 0, shape[1] - 1)
    xi = np.clip(np.arange(shape[2])[:, None] + np.arange(nkx) - nkx // 2, 0, shape[2] - 1)
    ref = np.einsum("zyjx,j->zyx", v[:, yi, :], ky)
    ref = np.einsum("zyxj,j->zyx", ref[:, :, xi], kx)
    base = 4096 + 64 + lead
    raw = vol.view(np.uint8).reshape(-1)
    lo = base & ~15
    mem = np.zeros(_round_up16(base + raw.size) - lo, np.uint8)
    mem[base - lo: base - lo + raw.size] = raw
    out = np.full(shape, np.nan)
    items = {t: conv.yx_y_items(plan, t) for t in range(plan.block[0])}
    for b in itertools.product(*(range(n) for n in plan.grid)):
        xs = {t: conv.yx_x_outputs(plan, shape, b, t) for t in range(plan.block[0])}
        for k, (y0, win) in enumerate(_walk_block(plan, vol, nky, nkx, base, b, mem, lo)):
            assert y0 == (b[1] * plan.tiles + k) * plan.ty
            ys = np.clip(y0 - nky // 2 + np.arange(g.ty + nky - 1), 0, shape[1] - 1)
            cs_ = np.clip(b[0] * plan.tx - nkx // 2 + np.arange(g.ncols), 0, shape[2] - 1)
            np.testing.assert_array_equal(win, vol[b[2]][np.ix_(ys, cs_)])
            tmp = np.full((g.ty, g.tmpw), np.nan)
            for t in range(plan.block[0]):
                for c, r0 in items[t]:
                    # the register window: rows r0 .. r0 + 16 + 4 ceil(nky / 4) - 1
                    assert r0 + conv.YX_RUN + gy4 <= g.rows
                    w = win[r0: r0 + conv.YX_RUN + nky - 1, c].astype(np.float64)
                    tmp[r0: r0 + conv.YX_RUN, c] = [w[u: u + nky] @ ky for u in range(conv.YX_RUN)]
            assert not np.isnan(tmp[:, : g.ncols]).any()
            for t in range(plan.block[0]):
                # the lane's float4 reads: tmp columns 8l .. 8l + 4 (nkx // 4) + 11,
                # l = lane mod 16
                assert 8 * (t % 16) + 4 * (nkx // 4) + 12 <= g.tmpw
                for z, y, x, kk, r in xs[t]:
                    if kk == k:
                        c = x - b[0] * plan.tx
                        assert c + nkx - 1 < g.ncols
                        out[z, y, x] = tmp[r, c: c + nkx] @ kx
    np.testing.assert_allclose(out, ref, rtol=1e-12)
