"""`tube_corr`'s routes on the CPU (pnr_tpu_torch/ops/tube_corr.py and the
engine of ops/zncc_fast.py): the tracer's route (`window` + `likelihood`)
and seed scoring (`eval_fused`) are bitwise the extract + corr chain they
replace, on float32 and bfloat16 fields; the window corners are the JAX
engine's, half-integer centres included; the earliest sigma wins a tie.
The CUDA kernel is held to this plain chain in tests/test_torch_kernels.py.
"""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import ENGINE_CASES, noisy_tube, tube_queries
from pnr_tpu.ops import zncc_fast as jzf
from pnr_tpu.ops.zncc_model import TubeZnccModel as JaxTubeZnccModel
from pnr_tpu_torch.ops import tube_corr as tc
from pnr_tpu_torch.ops.zncc import _FLT_MIN
from pnr_tpu_torch.ops.zncc_fast import TubePatchEngine, build_tube_maps_packed
from pnr_tpu_torch.ops.zncc_model import TubeZnccModel


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP, ZDIST = 2.0, 2.0
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def field(shape, sigmas, dtype):
    f = build_tube_maps_packed(torch.from_numpy(noisy_tube(shape)), TubeZnccModel(sigmas, False))
    return f.to(DTYPES[dtype])


def engine(sigmas, reuse=1):
    return TubePatchEngine(TubeZnccModel(sigmas, False), STEP, ZDIST, reuse=reuse, device="cpu")


def as_torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def assert_equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_tracer_route_bitwise_extract_corr(case, dtype):
    shape, sigmas, reuse, edges = ENGINE_CASES[case]
    eng = engine(sigmas, reuse)
    f = field(shape, sigmas, dtype)
    pos, d = as_torch(*tube_queries(shape, edges=edges))
    centre = pos.mean(dim=1)
    corners = eng.window(f, centre)
    patches, per_group = eng.extract(f, centre)
    assert corners.dtype == torch.int32 and corners.shape == (pos.shape[0], len(per_group), 3)
    assert torch.equal(corners, torch.stack(per_group, dim=1))
    groups = eng.groups(shape)
    # the extraction's iteration, and a later one reusing its windows
    for p in (pos, pos + torch.tensor([1.5, -0.5, 0.75])):
        want = eng.corr(shape, patches, per_group, p, d)
        assert_equal(eng.likelihood(f, corners, p, d), want)
        assert_equal(tc.tube_corr_plain(f, groups, corners, p, d, eng.tables)[:2], want)
    # the centroid's evaluation (N=1) in the same windows
    c1, d1 = pos[:, :1] + 0.25, d[:, :1].contiguous()
    assert_equal(eng.likelihood(f, corners, c1, d1), eng.corr(shape, patches, per_group, c1, d1))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sums_are_the_masked_line_sums(dtype):
    shape, sigmas = (24, 64, 96), (2.0, 4.0, 6.0)
    eng = engine(sigmas)
    f = field(shape, sigmas, dtype)
    pos, d = as_torch(*tube_queries(shape, seed=2))
    t, n = pos.shape[:2]
    corners = eng.window(f, pos.mean(dim=1))
    corr, sig, sums = tc.tube_corr_plain(f, eng.groups(shape), corners, pos, d, eng.tables)
    assert sums.shape == (t, n, len(sigmas), 3)
    # the samples of the extract + corr chain, summed over the line here
    patches, per_group = eng.extract(f, pos.mean(dim=1))
    vs, g0 = [], 0
    for pat, corner in zip(patches, per_group):
        gs, pz, py, px3 = pat.shape[1:]
        rel = tc.rel_coords(eng.tables, shape, (pz, py, px3 // 3), corner, pos, d, g0, g0 + gs)
        vs.append(tc.hat_sample_patch_plain(pat, rel)[..., :3])
        g0 += gs
    v = torch.cat(vs, dim=1).reshape(t, len(sigmas), n, eng.nv, 3)
    want = (v * eng.tables.vmask[None, :, None, :, None]).sum(dim=3).permute(0, 2, 1, 3)
    assert torch.equal(sums, want)
    assert_equal(tc.corr_from_sums(eng.tables, *(sums[..., c] for c in range(3))), (corr, sig))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(24, 64, 96), (20, 12, 14)])
def test_eval_fused_bitwise_the_previous_route(shape, dtype):
    """Seed scoring (B=1): a float32 field in one sigma_max window (the
    previous route: slice it, sample, finish), a bfloat16 field in the
    group windows (the previous route: extract + corr)."""
    sigmas = (2.0, 3.0)
    eng = engine(sigmas)
    f = field(shape, sigmas, dtype)
    pos, d = as_torch(*tube_queries(shape, t=150, n=1, seed=4))
    centre = pos[:, 0]
    got = eng.eval_fused(f, pos, d)
    if dtype == "bf16":
        want = eng.corr(shape, *eng.extract(f, centre), pos, d)
    else:
        pdims = eng.dims(shape)
        corner = eng.corners(shape, centre, pdims)
        assert torch.equal(eng.window(f, centre, single=True)[:, 0], corner)
        rel = tc.rel_coords(eng.tables, shape, pdims, corner, pos, d, 0, len(sigmas))
        t, s, m = rel.shape[:3]
        out = tc.hat_sample_field_plain(f, corner, rel.reshape(t, s * m, 4), pdims)
        want = tc.finish(eng.tables, out.reshape(t, s, m, 4)[..., :3], t, 1)[:2]
    assert_equal(got, want)


def test_corners_at_half_integer_centres_match_jax():
    """torch.round and jnp.round are both half-to-even: a .5 centre moves
    the window the same way in both engines."""
    shape, sigmas = (40, 64, 96), (2.0, 4.0, 6.0)
    eng = engine(sigmas)
    jeng = jzf.make_tube_patch_engine(JaxTubeZnccModel(sigmas, False), STEP, ZDIST, reuse=1)
    halves = np.array([0.5, 1.5, 2.5, 11.5, 12.5, 19.5, 20.5, 30.5, 47.5, 94.5], np.float32)
    rng = np.random.default_rng(9)
    centre = np.stack([rng.permutation(halves), rng.permutation(halves) % 63,
                       rng.permutation(halves) % 39], -1).astype(np.float32)
    maps = np.zeros((len(sigmas), *shape[:2], 3 * shape[2]), np.float32)
    _, want = jeng.extract(jnp.asarray(maps), jnp.asarray(centre))
    got = eng.window(torch.from_numpy(maps), torch.from_numpy(centre))
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(c) for c in want], axis=1))


def test_a_tie_goes_to_the_earliest_sigma():
    shape = (24, 64, 96)
    # an all-zero field: every sigma's correlation is gated to 0
    eng = engine((2.0, 4.0, 6.0))
    zero = torch.zeros_like(field(shape, (2.0, 4.0, 6.0), "f32"))
    pos, d = as_torch(*tube_queries(shape))
    corr, sig = eng.likelihood(zero, eng.window(zero, pos.mean(dim=1)), pos, d)
    assert (corr == 0).all() and (sig == 2.0).all()
    # two sigmas with the same constants and windows, told apart by label
    eng = engine((3.0, 3.0))
    eng.tables = eng.tables._replace(sigmas=torch.tensor([5.0, 7.0]))
    f = field(shape, (3.0, 3.0), "f32")
    corr, sig = eng.likelihood(f, eng.window(f, pos.mean(dim=1)), pos, d)
    assert (corr != 0).any() and (sig == 5.0).all()


def test_cpu_route_is_the_plain_chain_and_launches_nothing():
    shape, sigmas = (24, 64, 96), (2.0, 3.0)
    eng = engine(sigmas)
    f = field(shape, sigmas, "f32")
    pos, d = as_torch(*tube_queries(shape))
    corners = eng.window(f, pos.mean(dim=1))
    groups = eng.groups(shape)
    n = tc.TRACE_LAUNCHES, tc.SCORE_LAUNCHES
    corr, sig, sums = tc.tube_corr_plain(f, groups, corners, pos, d, eng.tables)
    for scoring in (False, True):
        out, got_sums = tc.tube_corr(f, groups, corners, pos, d, eng.tables, scoring=scoring)
        assert out.shape == (2, *pos.shape[:2])
        assert_equal((out[0], out[1], got_sums), (corr, sig, sums))
    assert (tc.TRACE_LAUNCHES, tc.SCORE_LAUNCHES) == n
    assert eng.layout(f).params is None


def test_kernel_params_hold_the_plain_chain_constants():
    sigmas = (2.0, 4.0, 6.0)
    eng = engine(sigmas)
    vdims = (128, 640, 640)
    groups = eng.groups(vdims)
    p = tc.KernelParams(eng.tables, groups, vdims, "cpu")
    s = p.struct
    # member for member csrc/tube_corr.cu's TubeParams: 376 4-byte members
    assert ctypes.sizeof(tc.TubeParams) == 4 * 376
    assert (s.S, s.NV, s.G) == (3, eng.nv, len(groups)) == (3, 9, 3)
    assert p.field_shape == (3, 128, 640, 3 * 640) and p.groups == 3
    # the whole field: no slab origin, the field's dims the volume's
    assert list(s.origin) == [0, 0, 0] and list(s.fdims) == list(vdims)
    # a slab of planes [40, 100) of that volume
    q = tc.KernelParams(eng.tables, groups, vdims, "cpu", (40, 0, 0), (60, 640, 640))
    assert list(q.struct.origin) == [40, 0, 0] and list(q.struct.fdims) == [60, 640, 640]
    assert list(q.struct.dims) == list(vdims) and q.field_shape == (3, 60, 640, 3 * 640)
    assert list(q.struct.vol_hi) == list(s.vol_hi)
    # the bytes the kernel reads, on the layout's device
    assert bytes(p.data.numpy()) == bytes(s) and p.device_index == -1
    assert list(s.group_of)[:3] == [0, 1, 2]
    assert [tuple(s.win[g]) for g in range(3)] == [g[2] for g in groups]
    assert list(s.vol_hi) == [np.float32(d - 1.001) for d in vdims]
    assert s.win_hi[2][1] == np.float32(32 - 1.001)
    assert s.flt_min == np.float32(_FLT_MIN) and s.flt_min != np.finfo(np.float32).tiny
    for name in ("alpha1", "alpha2", "gbar", "n", "corrc", "sigmas"):
        assert list(getattr(s, name))[:3] == getattr(eng.tables, name).tolist()
    assert [list(s.vgrid[i])[: eng.nv] for i in range(3)] == eng.tables.vgrid.tolist()
    assert [list(s.vmask[i])[: eng.nv] for i in range(3)] == eng.tables.vmask.tolist()
    with pytest.raises(ValueError, match=">= 2"):
        tc.KernelParams(eng.tables, [(0, 3, (1, 8, 8))], vdims, "cpu")
    with pytest.raises(ValueError, match="cover"):
        tc.KernelParams(eng.tables, groups[:2], vdims, "cpu")
    with pytest.raises(ValueError, match="at most 8 sigmas"):
        tc.KernelParams(engine((2.0,) * 9).tables, [(0, 9, (8, 8, 8))], vdims, "cpu")
