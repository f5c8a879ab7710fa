"""The port's sharded pipeline (`reconstruction_func_sharded`), its soma
stage, checkpoint and resume, midres dumps, planner and CLI, on the CPU.

The volume is tests/test_parallel.py's TestShardedReconstruction stack
(16, 40, 80), in both likelihood modes. The port runs on a 4-shard CPU
mesh, the JAX package on `pnr_tpu.parallel.make_mesh(4)` of the
conftest's 8-device CPU mesh. Bars: against JAX's sharded run, seed
overlap >= 0.9 (tests/test_torch_pipeline.py) and SWC F1 >= 0.85 (JAX's
bar for sharded against single-device, tests/test_parallel.py); against
the port's single-device run with the same (unfused) filter, F1 >= 0.85
and, since a trace inside its slab is the single-device trace, the
traced node graph n0 bitwise.
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from pnr_tpu.config import PNRConfig as JaxConfig
from pnr_tpu.parallel import make_mesh as jax_make_mesh
from pnr_tpu_torch import cli
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.graph.nodes import SOMA, NodeList
from pnr_tpu_torch.io.swc import read_swc, save_nodelist
from pnr_tpu_torch.parallel import make_mesh, min_devices, plan_sharded, shard_volume
from pnr_tpu_torch.pipeline import reconstruction_func, reconstruction_func_sharded
from pnr_tpu_torch.pipeline.reconstruct import soma_extraction
from pnr_tpu_torch.pipeline.sharded_reconstruct import soma_extraction_sharded
from pnr_tpu_torch.utils.swc_compare import compare_swc

N = 4
MESH = make_mesh(N, device="cpu")
#: the device memory the planner cases plan for (an 80-GB card)
MEM = 80 * 10**9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: beside other test workers and
    JAX's threads, torch's spinning OpenMP workers slowed this file's small
    ops by one to two orders of magnitude (a 40-s run took 324 s under two
    xdist workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFGS = {
    "tube": dict(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=40,
                 np=16, zdist=2.0, nodepervol=4, vol=9, wave_size=16, zncc_mode="tube"),
    "exact": dict(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=16,
                  np=10, zdist=2.0, nodepervol=4, vol=9, wave_size=16),
}


def tube_volume(shape=(16, 40, 80), seed=11):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] // 2) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    v = (200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
         * (x > 6) * (x < shape[2] - 7))
    return np.clip(v + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


def f1(a, b):
    pa, pb = tempfile.mktemp(suffix=".swc"), tempfile.mktemp(suffix=".swc")
    save_nodelist(a, pa)
    save_nodelist(b, pb)
    return compare_swc(read_swc(pa), read_swc(pb), dist=3.0, resample=1.0)


def same_graph(a: NodeList, b: NodeList) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)))
        for k in ("x", "y", "z", "sig", "corr", "type"))


@pytest.fixture(scope="module", params=["exact", "tube"])
def runs(request):
    """(mode, port sharded, port single-device, JAX sharded) on the stack."""
    from pnr_tpu.pipeline.sharded_reconstruct import reconstruction_func_sharded as jax_sharded

    mode = request.param
    vol = tube_volume()
    cfg = PNRConfig(**CFGS[mode], fused_frangi=False)
    port = reconstruction_func_sharded(vol, cfg, MESH, verbose=False)
    single = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    ref = jax_sharded(vol, JaxConfig(**CFGS[mode]), jax_make_mesh(N), verbose=False)
    return mode, port, single, ref


def test_seed_sets_match_jax_sharded(runs):
    _, port, _, ref = runs
    sp = {tuple(p) for p in port.seeds_pos.astype(int).tolist()}
    sj = {tuple(p) for p in ref.seeds_pos.astype(int).tolist()}
    assert len(sp & sj) >= 0.9 * max(len(sp), len(sj), 1), (len(sp), len(sj))


def test_f1_against_jax_sharded(runs):
    _, port, _, ref = runs
    assert len(port.tree) > 10
    s = f1(port.tree, ref.tree)
    assert s.f1 >= 0.85, s


def test_matches_single_device(runs):
    mode, port, single, _ = runs
    assert f1(port.tree, single.tree).f1 >= 0.85
    np.testing.assert_array_equal(port.j8, single.j8)
    np.testing.assert_array_equal(port.seeds_pos, single.seeds_pos)
    np.testing.assert_array_equal(port.seeds_corr, single.seeds_corr)
    assert port.trace_count == single.trace_count
    assert same_graph(port.n0, single.n0), mode
    assert port.n_handoffs > 0 and port.n_lost == 0 and port.n_requeued == 0
    assert set(port.timings) == {
        "frangi (sharded)", "seed extraction (sharded)", "seed selection & sorting (sharded)",
        "tracing (sharded, staged handoff)", "reconstruct"}


def test_forced_requeue_traces_all_seeds():
    """With two lanes a shard, overflowing seeds re-queue into later waves
    instead of vanishing: the same seeds are traced as with free lanes."""
    vol = tube_volume((16, 32, 64), seed=21)
    cfg = PNRConfig(sigmas=(2.0,), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=16, np=8,
                    zdist=2.0, nodepervol=4, vol=9, wave_size=8, zncc_mode="tube")
    free = reconstruction_func_sharded(vol, cfg, MESH, verbose=False)
    tight = reconstruction_func_sharded(vol, cfg, MESH, verbose=False, _lanes_override=2)
    assert tight.n_requeued > 0 and tight.n_lost == 0
    assert tight.trace_count == free.trace_count > 0
    assert len(tight.n0) > 2


def test_arbitrary_z_matches_single_device():
    """18 planes on 4 shards: replicate-padded to 20, the result in the
    original planes is the single-device one."""
    vol = tube_volume((18, 32, 64), seed=5)
    cfg = PNRConfig(sigmas=(2.0,), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=24, np=12,
                    zdist=2.0, nodepervol=4, vol=9, wave_size=16, zncc_mode="tube",
                    fused_frangi=False)
    got = reconstruction_func_sharded(vol, cfg, MESH, verbose=False)
    ref = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    assert got.j8.shape == vol.shape
    np.testing.assert_array_equal(got.j8, ref.j8)
    assert len(got.tree) > 5 and same_graph(got.n0, ref.n0)


def plane(shape=(1, 46, 96), seed=5, yc=23.0):
    """tests/test_parallel.py's TestSharded2D image, 46 rows (padded to 48)."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.arange(shape[1]), np.arange(shape[2]), indexing="ij")
    along = (0.7 + 0.3 * np.sin(x / 4.0)) * (x > 6) * (x < shape[2] - 7)
    img = 200.0 * np.exp(-((y - yc) ** 2) / (2 * 2.5**2)) * along
    img = img + rng.normal(0, 5, (shape[1], shape[2]))
    return np.clip(img, 0, 255).astype(np.uint8)[None]


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_2d_sharded_over_y_matches_single_device(mode):
    vol = plane()
    cfg = PNRConfig(sigmas=(2.0,), tolerance=10.0, znccth=0.4, kappa=2.0, step=2, ni=30, np=16,
                    zdist=2.0, nodepervol=4, vol=9, wave_size=16, zncc_mode=mode)
    got = reconstruction_func_sharded(vol, cfg, MESH, verbose=False)
    ref = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    assert got.j8.shape == vol.shape
    np.testing.assert_array_equal(got.j8, ref.j8)
    assert got.trace_count >= 1 and len(got.tree) > 5
    assert np.median(np.abs(np.asarray(got.tree.y[1:]) - 23.0)) < 3.0
    assert not np.asarray(got.n0.z).any()
    assert f1(got.tree, ref.tree).f1 >= 0.85
    assert same_graph(got.n0, ref.n0)


def soma_volume(shape=(16, 48, 48), seed=7):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    blob = 230.0 * np.exp(-((x - 24) ** 2 + (y - 24) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2)
                          / (2 * 6.0**2))
    return np.clip(blob + rng.normal(20, 6, shape), 0, 255).astype(np.uint8)


SOMA_CFG = dict(sigmas=(2.0,), somaradius=5, znccth=0.5, kappa=2.0, step=2, ni=10, np=8,
                zdist=2.0, nodepervol=4, vol=9)


@pytest.mark.parametrize("shape", [(16, 48, 48), (14, 48, 48), (1, 48, 48)])
def test_soma_stage_bitwise_single_device(shape):
    """The sharded soma stage (per-slab stencils, summed histogram, host
    components) against the port's single-device stage, bitwise, with Z
    (or, on a plane, Y) both a mesh multiple and replicate-padded."""
    vol = soma_volume(shape)
    cfg = PNRConfig(**SOMA_CFG)
    nodes_ref = NodeList()
    smap_ref = soma_extraction(vol, cfg, nodes_ref, "cpu")
    is2d = shape[0] == 1
    from pnr_tpu_torch.pipeline.sharded_reconstruct import _pad_axis_replicate

    rep = (np.ascontiguousarray(_pad_axis_replicate(vol, N, 1).transpose(1, 0, 2)) if is2d
           else _pad_axis_replicate(vol, N, 0))
    nodes = NodeList()
    smap = soma_extraction_sharded(shard_volume(rep, MESH), vol.shape, cfg, nodes, MESH,
                                   is2d=is2d)
    np.testing.assert_array_equal(smap, smap_ref)
    assert len(nodes) == len(nodes_ref) > 1 and nodes.type[1] == SOMA
    np.testing.assert_array_equal(np.asarray(nodes.x), np.asarray(nodes_ref.x))


def test_soma_matches_jax_sharded():
    from pnr_tpu.graph.nodes import NodeList as JaxNodes
    from pnr_tpu.parallel import shard_volume as jax_shard_volume
    from pnr_tpu.pipeline.sharded_reconstruct import soma_extraction_sharded as jax_soma

    vol = soma_volume()
    jmesh = jax_make_mesh(N)
    want = jax_soma(jax_shard_volume(vol, jmesh), vol.shape, JaxConfig(**SOMA_CFG), JaxNodes(),
                    jmesh)
    got = soma_extraction_sharded(shard_volume(vol, MESH), vol.shape, PNRConfig(**SOMA_CFG),
                                  NodeList(), MESH)
    np.testing.assert_array_equal(got, want)


def test_save_midres_matches_single_device():
    """The sharded run with save_midres returns the single-device run's
    artifact set: direction maps and trace density bitwise (same unfused
    filter), the soma map, and the n0/n1/n2 snapshots."""
    vol = tube_volume()
    cfg = PNRConfig(**dict(CFGS["tube"], somaradius=4, ni=20, save_midres=True,
                           fused_frangi=False))
    got = reconstruction_func_sharded(vol, cfg, MESH, verbose=False)
    ref = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    assert set(got.midres) == set(ref.midres)
    for k in ("vx", "vy", "vz", "trace_density", "smap8"):
        np.testing.assert_array_equal(got.midres[k], ref.midres[k])
    assert len(got.midres["n1"]) == len(got.midres["n0res"])
    assert len(got.midres["n2"]) <= len(got.midres["n1"])


def test_checkpoint_cut_and_resume_bitwise(tmp_path):
    """A run cut by the trace cap inside its first wave checkpoints its
    unstarted seeds; the resume finishes bitwise the uninterrupted run. A
    single-device checkpoint resumes on the mesh to the same graph."""
    vol = tube_volume((16, 32, 96), seed=23)
    cfg = PNRConfig(sigmas=(2.0,), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=16, np=8,
                    zdist=2.0, nodepervol=4, vol=9, wave_size=2, zncc_mode="tube")
    full = reconstruction_func_sharded(vol, cfg, MESH, verbose=False)
    cut = dataclasses.replace(cfg, max_trace_count=1, wave_size=6)
    ck = str(tmp_path / "sharded.npz")
    part = reconstruction_func_sharded(vol, cut, MESH, verbose=False, checkpoint_path=ck)
    assert 0 < part.trace_count < full.trace_count
    assert np.load(ck)["pending"].size > 0, "the cap did not cut the wave"
    resumed = reconstruction_func_sharded(vol, cfg, make_mesh(2, device="cpu"), verbose=False,
                                          checkpoint_path=ck, resume=True)
    assert resumed.trace_count == full.trace_count
    assert same_graph(resumed.n0, full.n0)

    ck2 = str(tmp_path / "single.npz")
    reconstruction_func(vol, cut, verbose=False, checkpoint_path=ck2, device="cpu")
    crossed = reconstruction_func_sharded(vol, cfg, MESH, verbose=False, checkpoint_path=ck2,
                                          resume=True)
    assert crossed.trace_count == full.trace_count and same_graph(crossed.n0, full.n0)


# -- the planner: tests/test_plan.py's cases on the port's constants ---------------------


def plan_cfg(mode="tube", sigmas=(2.0, 4.0, 6.0), **kw):
    return PNRConfig(sigmas=sigmas, znccth=0.5, kappa=3.0, step=2, ni=100, np=20, zdist=2.0,
                     nodepervol=4, vol=9, zncc_mode=mode, **kw)


@pytest.mark.parametrize("mode", ["tube", "exact"])
@pytest.mark.parametrize("shape", [(256, 512, 512), (512, 1024, 1024)])
def test_plan_more_devices_shrink_per_shard_peak(shape, mode):
    """tests/test_plan.py's case, on JAX's (512, 1024, 1024) too: the slab
    takes the route with the lower planned peak (`slab_filter_route`), so
    a route change never raises a shard's peak as the mesh grows."""
    peaks = [plan_sharded(shape, plan_cfg(mode), n, MEM).peak_bytes for n in (1, 2, 4, 8)]
    assert all(a > b for a, b in zip(peaks, peaks[1:])), peaks


def test_plan_main_stack_slabs_of_four_shards_stay_monolithic():
    """The 54-plane halo slabs of the (128, 640, 640) stack on four shards
    (22.1 Mvox) lie under the 35.7-Mvox crossing of the two routes."""
    p = plan_sharded((128, 640, 640), plan_cfg(), 4, MEM)
    assert "frangi" in p.stages, p.stages


def test_plan_main_stack_fits_one_card():
    for mode in ("exact", "tube"):
        p = plan_sharded((128, 640, 640), plan_cfg(mode), 1, MEM)
        assert p.fits, p.summary()


def test_plan_exact_mode_is_memory_lean():
    t = plan_sharded((512, 1024, 1024), plan_cfg("tube"), 4, MEM)
    e = plan_sharded((512, 1024, 1024), plan_cfg("exact"), 4, MEM)
    assert e.stages["tracing (exact)"] < t.stages["tracing (tube)"] / 5


def test_plan_2048_exact_finds_a_mesh_with_the_tiled_filter():
    p = min_devices((2048, 2048, 2048), plan_cfg("exact"), MEM)
    assert p.fits and 2 <= p.n_devices <= 16, p.summary()
    assert any("tiled" in k for k in p.stages), p.stages


def test_plan_tube_names_the_binding_stage():
    """2048^3 tube fits a finite mesh with the auto (bfloat16) field; a
    plane too large for one card even one slice a shard makes
    min_devices name the stage that binds instead of looping."""
    p = min_devices((2048, 2048, 2048), plan_cfg("tube"), MEM)
    assert p.fits and p.n_devices <= 64, (p.n_devices, p.peak_stage)
    with pytest.raises(ValueError, match="tracing \\(tube\\)"):
        min_devices((2048, 8192, 8192), plan_cfg("tube", tube_map_dtype="f32"), MEM)


def test_plan_2d_shards_over_y():
    p1 = plan_sharded((1, 4096, 4096), plan_cfg(sigmas=(2.0, 3.0)), 1, MEM)
    p8 = plan_sharded((1, 4096, 4096), plan_cfg(sigmas=(2.0, 3.0)), 8, MEM)
    assert p8.peak_bytes < p1.peak_bytes


def test_plan_summary_and_forced_routes():
    s = plan_sharded((128, 640, 640), plan_cfg(), 2, MEM).summary()
    assert "GiB/shard" in s and "fits" in s
    p = plan_sharded((128, 640, 640), plan_cfg(), 1, MEM, blocked_frangi=True)
    assert any(("tiled" in k or "Z-blocked" in k) for k in p.stages)


def test_plan_larger_stage_iters_grows_trace_halo():
    a = plan_sharded((256, 512, 512), plan_cfg(), 4, MEM, stage_iters=4)
    b = plan_sharded((256, 512, 512), plan_cfg(), 4, MEM, stage_iters=16)
    assert b.stages["tracing (tube)"] > a.stages["tracing (tube)"]


def test_probe_shapes_match_saved(tmp_path):
    """The header probe `--plan` reads (tests/test_plan.py's case)."""
    from pnr_tpu_torch.io.volume import probe_volume_shape, save_volume

    vol = (np.random.default_rng(42).random((6, 9, 13)) * 255).astype(np.uint8)
    for ext in (".npy", ".v3draw", ".v3dpbd", ".tif"):
        p = str(tmp_path / ("v" + ext))
        save_volume(p, vol)
        assert probe_volume_shape(p) == (6, 9, 13)
    np.save(str(tmp_path / "plane.npy"), vol[0])
    assert probe_volume_shape(str(tmp_path / "plane.npy")) == (1, 9, 13)


# -- the CLI ---------------------------------------------------------------------------

PARAMS = ["2,3", "0", "10", "0.5", "2", "2", "24", "12", "2", "4", "9"]


def test_cli_mesh_on_cpu_writes_the_api_swc(tmp_path):
    vol = tube_volume()
    src = str(tmp_path / "stack.npy")
    np.save(src, vol)
    out = str(tmp_path / "out.swc")
    assert cli.main(["-i", src, "-p", *PARAMS, "--mesh", "2", "--device", "cpu", "-o", out,
                     "--zncc-mode", "tube", "--quiet"]) == 0
    cfg = dataclasses.replace(PNRConfig.from_cli_params(PARAMS), zncc_mode="tube")
    res = reconstruction_func_sharded(vol, cfg, make_mesh(2, device="cpu"), verbose=False)
    rows = read_swc(out)
    assert len(rows) == len(res.tree) - 1 > 10
    np.testing.assert_allclose(rows[:, 2], np.asarray(res.tree.x[1:]), atol=1e-3)


def test_cli_mesh_without_a_card_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = str(tmp_path / "stack.npy")
    np.save(src, np.zeros((8, 16, 16), np.uint8))
    assert cli.main(["-i", src, "-p", *PARAMS, "--mesh", "2"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("mesh", [[], ["--mesh", "2"]])
def test_cli_plan_reads_the_header_only(tmp_path, monkeypatch, capsys, mesh):
    """--plan exits without reconstructing: it reads the shape from the
    header, plans against the card's memory, and writes nothing."""
    from pnr_tpu_torch.parallel import plan

    def no_voxels(*a, **k):
        raise AssertionError("--plan read the voxels")

    monkeypatch.setattr(cli, "load_volume", no_voxels)
    monkeypatch.setattr(plan, "card_memory_bytes", lambda device="cuda": MEM)
    src = str(tmp_path / "v.npy")
    np.save(src, np.zeros((64, 128, 128), np.uint8))
    rc = cli.main(["-i", src, "--plan", *mesh, "-p", "2,4,6", "0", "10", "0.5", "3", "2", "100",
                   "20", "2", "4", "9"])
    out = capsys.readouterr().out
    assert rc == 0 and "GiB/shard" in out and "fits" in out
    assert ("over 2 card(s)" in out) == bool(mesh)
    assert not list(tmp_path.glob("*.swc"))


def test_cli_watch_mesh_is_not_ported(tmp_path, monkeypatch):
    """`--watch --mesh 2` no longer raises: it serves the directory through
    the sharded server, which stops at the sentinel having written nothing
    (tests/test_torch_batch_dp.py serves stacks through it)."""
    from pnr_tpu_torch.pipeline import serve

    called = []
    sharded = serve._watch_sharded
    monkeypatch.setattr(serve, "_watch_sharded", lambda *a, **k: called.append(a[2]) or
                        sharded(*a, **k))
    (tmp_path / ".stop").touch()
    assert cli.main(["-i", str(tmp_path), "-p", *PARAMS, "--watch", "--mesh", "2", "--device",
                     "cpu", "--quiet"]) == 0
    assert called == [make_mesh(2, device="cpu")]
    assert not list(tmp_path.glob("*.swc"))
