"""The PyTorch port imports nothing of jax or of the JAX package, keeps its
own copies of the JAX package's host modules, and never runs silently on
the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = (
    "pnr_tpu_torch",
    "pnr_tpu_torch.__main__",
    "pnr_tpu_torch.cli",
    "pnr_tpu_torch.compare",
    "pnr_tpu_torch.config",
    "pnr_tpu_torch.utils.runtime",
    "pnr_tpu_torch.utils.exporters",
    "pnr_tpu_torch.utils.swc_compare",
    "pnr_tpu_torch.utils.stats",
    "pnr_tpu_torch.utils.spans",
    "pnr_tpu_torch.native",
    "pnr_tpu_torch.hostpath",
    "pnr_tpu_torch.hostpath.threefry",
    "pnr_tpu_torch.hostpath.filters",
    "pnr_tpu_torch.hostpath.tube",
    "pnr_tpu_torch.hostpath.tracer",
    "pnr_tpu_torch.hostpath.pipeline",
    "pnr_tpu_torch.io.volume",
    "pnr_tpu_torch.io.pbd",
    "pnr_tpu_torch.io.swc",
    "pnr_tpu_torch.graph.nodes",
    "pnr_tpu_torch.graph.build",
    "pnr_tpu_torch.graph.trees",
    "pnr_tpu_torch.graph.refine",
    "pnr_tpu_torch.ops.cuda",
    "pnr_tpu_torch.ops.conv",
    "pnr_tpu_torch.ops.gaussian",
    "pnr_tpu_torch.ops.hessian",
    "pnr_tpu_torch.ops.eig3",
    "pnr_tpu_torch.ops.frangi",
    "pnr_tpu_torch.ops.frangi_fused",
    "pnr_tpu_torch.ops.frangi_blocked",
    "pnr_tpu_torch.ops.morphology",
    "pnr_tpu_torch.ops.thresholds",
    "pnr_tpu_torch.ops.interp",
    "pnr_tpu_torch.ops.zncc",
    "pnr_tpu_torch.ops.zncc_model",
    "pnr_tpu_torch.ops.zncc_exact",
    "pnr_tpu_torch.ops.tube_corr",
    "pnr_tpu_torch.ops.threefry",
    "pnr_tpu_torch.ops.zncc_fast",
    "pnr_tpu_torch.ops.slab",
    "pnr_tpu_torch.parallel",
    "pnr_tpu_torch.parallel.halo",
    "pnr_tpu_torch.parallel.sharded",
    "pnr_tpu_torch.parallel.multihost",
    "pnr_tpu_torch.parallel.handoff",
    "pnr_tpu_torch.parallel.plan",
    "pnr_tpu_torch.parallel.batch_dp",
    "pnr_tpu_torch.seeds.extract",
    "pnr_tpu_torch.seeds.alt",
    "pnr_tpu_torch.smc.directions",
    "pnr_tpu_torch.smc.priors",
    "pnr_tpu_torch.smc.tracker",
    "pnr_tpu_torch.smc.graphs",
    "pnr_tpu_torch.smc.clustering",
    "pnr_tpu_torch.pipeline",
    "pnr_tpu_torch.pipeline.reconstruct",
    "pnr_tpu_torch.pipeline.checkpoint",
    "pnr_tpu_torch.pipeline.serve",
    "pnr_tpu_torch.pipeline.sharded_reconstruct",
    "pnr_tpu_torch.ui",
    "pnr_tpu_torch.ui.dialog",
)


def _reference_module(name: str) -> bool:
    """jax, or the JAX package (`pnr_tpu_torch` also starts with `pnr_tpu`)."""
    return name in ("jax", "pnr_tpu") or name.startswith(("jax.", "pnr_tpu."))


def test_port_imports_no_jax():
    # a fresh interpreter: this process already imported jax (conftest)
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'pnr_tpu')\n"
        "             or m.startswith(('jax.', 'pnr_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_multi_device_modules_import_no_jax():
    """The batch-over-a-mesh and multi-process modules, and the child script
    the two-process tests spawn, load no jax and no pnr_tpu in a fresh
    interpreter."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "import pnr_tpu_torch.parallel.batch_dp, pnr_tpu_torch.parallel.multihost as mh\n"
        "import _torch_mp_child\n"
        "assert callable(mh.init_multihost) and callable(mh.make_global_mesh)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'pnr_tpu')\n"
        "             or m.startswith(('jax.', 'pnr_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", ["chip_smoke.py", "pnr_tpu_torch", "tests/_torch_phantoms.py",
                                  "tests/_torch_cases.py", "tests/_torch_mp_child.py"])
def test_sources_import_no_reference_module(path):
    """No import statement of chip_smoke.py, the port, or the jax-free
    test helpers that chip_smoke.py and the card tests import names jax
    or pnr_tpu, not even inside a function."""
    root = os.path.join(REPO, path)
    files = [root] if root.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")
    ]
    for fname in files:
        with open(fname) as f:
            tree = ast.parse(f.read(), fname)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_reference_module(n) for n in names), (fname, node.lineno, names)


def test_pipeline_exports_the_serving_entry_points():
    import pnr_tpu_torch.pipeline as pipeline
    from pnr_tpu_torch.pipeline.reconstruct import reconstruction_batch
    from pnr_tpu_torch.pipeline.serve import watch_and_reconstruct

    assert pipeline.reconstruction_batch is reconstruction_batch
    assert pipeline.watch_and_reconstruct is watch_and_reconstruct
    assert {"reconstruction_batch", "watch_and_reconstruct"} <= set(pipeline.__all__)


def test_the_sharded_entry_points_are_exported():
    import pnr_tpu_torch.parallel as parallel
    import pnr_tpu_torch.pipeline as pipeline
    from pnr_tpu_torch.pipeline.sharded_reconstruct import reconstruction_func_sharded

    assert pipeline.reconstruction_func_sharded is reconstruction_func_sharded
    names = {"make_mesh", "shard_volume", "halo_exchange_z", "halo_exchange_z_aligned",
             "frangi3d_sharded", "frangi2d_sharded", "normalize_to_u8_sharded", "plan_sharded",
             "min_devices", "reconstruction_batch_dp", "reconstruction_batch_sharded",
             "split_mesh", "init_multihost", "make_global_mesh", "shard_volume_global",
             "slab_filter_route"}
    assert names <= set(parallel.__all__) and all(callable(getattr(parallel, n)) for n in names)


# The JAX package's library names the port carries beside its pipeline
# (ROADMAP Queue 1 item 16), as (module, name): each with JAX's parameters.
PORTED_NAMES = [
    ("seeds.extract", "max_points_device"), ("seeds.extract", "extract_seeds"),
    ("seeds.extract", "decode_directions"), ("parallel.sharded", "seeds_sharded"),
    ("parallel.sharded", "build_sharded_step"), ("parallel.sharded", "build_local_trace_step"),
    ("parallel.handoff", "build_handoff_trace_step"), ("parallel.handoff", "stitch_estimates"),
    ("pipeline.sharded_reconstruct", "build_seed_scorer"), ("smc.tracker", "TraceResult"),
    ("smc.tracker", "BatchedTracker.trace_wave"), ("smc.directions", "nearest_direction"),
    ("ops.zncc", "zncc_batch"), ("ops.zncc", "make_zncc_fn"), ("ops.zncc", "ZNCC_CHUNK"),
    ("ops.interp", "interpz"), ("seeds.alt", "frangi3d_with_scale"), ("seeds.alt", "extract3d_alt"),
    ("smc.clustering", "mean_shift"), ("smc.clustering", "cluster_labels"),
    ("smc.clustering", "largest_cluster"), ("graph.refine", "non_blurring_reference"),
    ("graph.refine", "refine_blurring"), ("graph.refine", "group0"),
    ("pipeline.reconstruct", "sphere_offsets"), ("pipeline.reconstruct", "soma_extraction_alt"),
    ("utils.stats", "quantile"), ("utils.stats", "mode"), ("utils.stats", "descending"),
    ("utils.stats", "get_k_highest"), ("utils.stats", "probability_distribution"),
    ("hostpath", "host_reconstruction_func"),
]


@pytest.mark.parametrize("module,name", PORTED_NAMES, ids=[f"{m}.{n}" for m, n in PORTED_NAMES])
def test_ported_name_has_jax_parameters(module, name):
    """The port's name takes JAX's parameters, in JAX's order, beside any
    it adds at the end (`device=`, a chunking knob): a caller of the JAX
    package's function calls the port's the same way."""
    import importlib
    import inspect

    def resolve(pkg):
        obj = importlib.import_module(f"{pkg}.{module}")
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    port, ref = resolve("pnr_tpu_torch"), resolve("pnr_tpu")
    if not callable(ref) or inspect.isclass(ref):
        assert type(port) is type(ref) and (port == ref if not inspect.isclass(ref) else True)
        if inspect.isclass(ref) and hasattr(ref, "__dataclass_fields__"):
            assert list(port.__dataclass_fields__) == list(ref.__dataclass_fields__)
        return
    theirs = list(inspect.signature(getattr(ref, "__wrapped__", ref)).parameters)
    ours = list(inspect.signature(port).parameters)
    assert ours[:len(theirs)] == theirs, (ours, theirs)


def test_every_port_module_is_listed():
    """PORT_MODULES covers every module of the package (but the bare
    subpackage initialisers), so the fresh-interpreter check above imports
    them all."""
    root = os.path.join(REPO, "pnr_tpu_torch")
    found = set()
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".py") and f != "__init__.py":
                found.add(os.path.relpath(os.path.join(d, f), REPO)[:-3].replace(os.sep, "."))
    assert found <= set(PORT_MODULES), sorted(found - set(PORT_MODULES))


def test_config_matches_jax():
    from pnr_tpu.config import PNRConfig as JaxConfig
    from pnr_tpu_torch.config import PNRConfig

    ours = [(f.name, f.default) for f in dataclasses.fields(PNRConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs
    params = ["2,4,6", "0", "10", "0.5", "3", "2", "100", "20", "2", "4", "9"]
    assert (PNRConfig.from_cli_params(params).provenance_comment()
            == JaxConfig.from_cli_params(params).provenance_comment())


def _native_case(name, rng):
    """Seeded inputs for one native entry point, as (args, kwargs)."""
    if name == "max_finder_stack":
        vol = rng.integers(0, 256, (4, 32, 40), dtype=np.uint8)
        return (vol, 10.0), {}
    if name == "commit_steps_native":
        l, h, w = 12, 20, 24
        steps = np.cumsum(rng.uniform(-1.5, 1.5, (40, 3)), axis=0) + (w / 2, h / 2, l / 2)
        pos = np.clip(steps, 0, (w - 1, h - 1, l - 1))
        offs = np.array([(dx, dy, 0) for dx in (-1, 0, 1) for dy in (-1, 0, 1)], np.int32)
        return (np.zeros((l, h, w), np.int32), np.zeros((l, h, w), np.int32), None, offs, 4,
                pos, np.ones(len(pos), np.uint8), 0, len(pos), 1), {}
    if name == "mean_shift_grid":
        p4 = np.concatenate([rng.uniform(0, 40, (300, 3)), rng.uniform(1, 3, (300, 1))], 1)
        return (p4.astype(np.float32), 1.5, 4, 1e-4), {}
    n = 200
    cols = [rng.uniform(0, 30, n).astype(np.float32) for _ in range(3)]
    sig, corr = rng.uniform(1, 3, n), rng.uniform(0, 1, n)
    soma = (rng.random(n) < 0.02).astype(np.uint8)
    return (*cols, sig, corr, soma, 2.0), {}


@pytest.mark.parametrize(
    "name", ["max_finder_stack", "commit_steps_native", "mean_shift_grid", "group_nodes"]
)
def test_native_copy_matches_jax_package(name):
    from pnr_tpu import native as jax_native
    from pnr_tpu_torch import native

    assert native.have_native()
    args_a, _ = _native_case(name, np.random.default_rng(9))
    args_b, _ = _native_case(name, np.random.default_rng(9))
    got = getattr(native, name)(*args_a)
    want = getattr(jax_native, name)(*args_b)
    if name == "commit_steps_native":  # also mutates the maps in place
        assert got == want
        np.testing.assert_array_equal(args_a[0], args_b[0])
        np.testing.assert_array_equal(args_a[1], args_b[1])
        return
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def test_native_builds_into_the_port_build_dir():
    from pnr_tpu_torch import native

    build = os.path.join(REPO, "pnr_tpu_torch", "_build")
    assert os.path.dirname(native.library_path()) == build
    assert native.have_native() and os.path.exists(native.library_path())


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot be exercised")
    from pnr_tpu_torch.config import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruction_func

    vol = np.zeros((8, 16, 16), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reconstruction_func(vol, PNRConfig(), verbose=False, device="cuda")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot be exercised")
    from pnr_tpu_torch.config import PNRConfig
    from pnr_tpu_torch.ops.zncc_fast import TubePatchEngine, tube_tables
    from pnr_tpu_torch.ops.zncc_model import TubeZnccModel
    from pnr_tpu_torch.pipeline import reconstruction_func

    with pytest.raises(RuntimeError, match="no CUDA device"):
        reconstruction_func(np.zeros((8, 16, 16), np.uint8), PNRConfig(), verbose=False)
    from pnr_tpu_torch.pipeline import reconstruction_batch

    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(reconstruction_batch([np.zeros((8, 16, 16), np.uint8)], PNRConfig()))
    model = TubeZnccModel((2.0,), False)
    with pytest.raises((RuntimeError, AssertionError)):
        TubePatchEngine(model, 2, 2.0)  # its tables go to the card
    tables = tube_tables(model, "cpu")
    assert TubePatchEngine(model, 2, 2.0, tables=tables).tables.alpha1.device.type == "cpu"


def test_cuda_wrappers_reject_cpu_tensors_on_the_kernel_route():
    """The CUDA routes validate their inputs instead of falling back."""
    from pnr_tpu_torch.ops import frangi_fused, zncc_exact
    from pnr_tpu_torch.ops.zncc_model import ZnccTemplates

    vol = torch.zeros((8, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frangi_fused._frangi3d_cuda(vol, (2.0,), 2.0, 0.5, 0.5, 500.0, False)
    tables = zncc_exact.template_tables(ZnccTemplates((2.0,), False), "cpu")
    corner = torch.zeros((1, 3), dtype=torch.int32)
    qs = torch.zeros((1, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        zncc_exact._exact_sums_cuda(vol, corner, qs, tables, (8, 16, 16))


def test_tube_wrappers_reject_cpu_tensors_on_the_kernel_route():
    """`tube_corr` and the map build's 1-D correlation validate their
    inputs on the CUDA route instead of falling back to the plain versions."""
    from pnr_tpu_torch.ops import gaussian, tube_corr
    from pnr_tpu_torch.ops.zncc_model import TubeZnccModel

    tables = tube_corr.tube_tables(TubeZnccModel((2.0,), False), "cpu")
    params = tube_corr.KernelParams(tables, [(0, 1, (4, 4, 4))], (8, 8, 8), "cpu")
    maps = torch.zeros((1, 8, 8, 24))
    corners = torch.zeros((1, 1, 3), dtype=torch.int32)
    pos = torch.zeros((1, 5, 3))
    n = tube_corr.TRACE_LAUNCHES, tube_corr.SCORE_LAUNCHES
    for scoring in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            tube_corr._tube_corr_cuda(maps, corners, pos, pos, params, scoring)
    assert (tube_corr.TRACE_LAUNCHES, tube_corr.SCORE_LAUNCHES) == n
    with pytest.raises(ValueError, match="CUDA tensor"):
        gaussian._conv1d_cuda(torch.zeros((4, 4, 4)), np.ones(3, np.float32), 0)
    with pytest.raises(TypeError, match="uint8 or float32"):
        gaussian._conv1d_cuda(torch.zeros((4, 4, 4), dtype=torch.float64), np.ones(3), 0)


def test_conv_wrappers_reject_cpu_tensors_on_the_kernel_route():
    """K3, K4 and K7's check validate their inputs on the CUDA route
    instead of falling back to the plain versions."""
    from pnr_tpu_torch.ops import conv, cuda

    taps = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv._conv1d_axis_cuda(torch.zeros((4, 4, 4)), taps, 0, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv._conv_yx_cuda(torch.zeros((4, 4, 4), dtype=torch.uint8), taps, taps)
    with pytest.raises(TypeError, match="uint8 or float32"):
        conv._conv1d_axis_cuda(torch.zeros((4, 4, 4), dtype=torch.float64), taps, 0, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda.self_check("cpu")
