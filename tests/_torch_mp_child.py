"""One process of a two-process torch.distributed (gloo) group running the
port's sharded layer across the process boundary; jax-free.

Spawned by tests/test_torch_multiprocess.py, the port's counterpart of
tests/test_multiprocess.py and its `_mp_*_child.py` scripts. Each process
joins the group through `parallel.multihost.init_multihost`, brings four
CPU shards to a global mesh of eight (`make_global_mesh`), and runs one
case:

    frangi    the sharded filter over the mesh, each local shard bitwise
              the monolithic `frangi3d`, Jmin/Jmax equal;
    seeds     the per-shard seed extraction with `fetch_replicated` and
              `exchange` refusing any volume-sized payload, the seed set
              equal to the host flood on the gathered J8;
    pipeline  `reconstruction_func_sharded` in 3-D and 2-D; rank 0 writes
              the result to OUT for the parent to hold against the
              single-process eight-shard run. A 3-D run cut by the trace
              cap checkpoints (rank 0 alone writes), every rank resumes
              from the file to the uninterrupted run's result, and a
              resume without it raises on every rank.

Usage: python tests/_torch_mp_child.py CASE RANK PORT [OUT]
"""

import dataclasses
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from pnr_tpu_torch.config import PNRConfig  # noqa: E402

#: tests/_mp_common.py's MP_CFG and MP_CFG_2D
MP_CFG = PNRConfig(
    sigmas=(2.0, 3.0), somaradius=4, tolerance=10.0, znccth=0.4, kappa=2.0,
    step=2, ni=16, np=8, zdist=2.0, nodepervol=4, vol=9, wave_size=16,
    zncc_mode="tube", tree_size_min=3,
)
MP_CFG_2D = PNRConfig(
    sigmas=(2.0,), tolerance=10.0, znccth=0.4, kappa=2.0, step=2,
    ni=16, np=8, zdist=2.0, nodepervol=4, vol=9, wave_size=16,
    zncc_mode="tube", tree_size_min=3,
)
SHARDS_PER_PROCESS = 4


def mp_phantom() -> np.ndarray:
    """tests/_mp_common.py's soma blob and bounded tube, (16, 32, 56)."""
    shape = (16, 32, 56)
    rng = np.random.default_rng(0)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    zc = shape[0] / 2
    soma = 240.0 * np.exp(
        -((x - 10) ** 2 + (y - 16) ** 2 + ((z - zc) * 2.0) ** 2) / (2 * 4.5**2))
    tube = 190.0 * np.exp(
        -((y - 16) ** 2 + ((z - zc) * 2.0) ** 2) / (2 * 2.5**2)) * (x > 14) * (x < 50)
    return np.clip(soma + tube + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


def mp_phantom_2d() -> np.ndarray:
    """tests/_mp_common.py's one-plane image, (1, 50, 56): Y = 50 does not
    divide eight shards."""
    shape_yx = (50, 56)
    rng = np.random.default_rng(1)
    y, x = np.meshgrid(np.arange(shape_yx[0]), np.arange(shape_yx[1]), indexing="ij")
    img = 200.0 * np.exp(-((y - 25) ** 2) / (2 * 2.5**2)) * (
        0.7 + 0.3 * np.sin(x / 4.0)) * (x > 6) * (x < 50)
    return np.clip(img + rng.normal(0, 5, shape_yx), 0, 255).astype(np.uint8)[None]


def frangi_volume() -> np.ndarray:
    """tests/_mp_frangi_child.py's (16, 24, 40) tube: two slices a shard, a
    filter halo of seven reaching across the process boundary."""
    shape = (16, 24, 40)
    rng = np.random.default_rng(7)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 12) ** 2 + ((z - 8) * 2.0) ** 2
    return np.clip(200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
                   + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


def case_frangi(rank, mesh):
    import torch

    from pnr_tpu_torch.ops.frangi import frangi3d, normalize_to_u8
    from pnr_tpu_torch.parallel import frangi3d_sharded, normalize_to_u8_sharded
    from pnr_tpu_torch.parallel.multihost import shard_volume_global

    vol = frangi_volume()
    shards = shard_volume_global(vol, mesh)
    assert sum(t is not None for t in shards) == SHARDS_PER_PROCESS
    j, jmin, jmax, vx, vy, vz = frangi3d_sharded(shards, (2.0, 3.0), 2.0, mesh)
    j8 = normalize_to_u8_sharded(j, jmin, jmax)
    rj, rjmin, rjmax, rvx, rvy, rvz = frangi3d(torch.from_numpy(vol), (2.0, 3.0), 2.0)
    rj8 = normalize_to_u8(rj, rjmin, rjmax)
    assert torch.equal(jmin, rjmin) and torch.equal(jmax, rjmax)
    zl = vol.shape[0] // mesh.size
    checked = 0
    for got, want in ((j8, rj8), (vx, rvx), (vy, rvy), (vz, rvz)):
        for s, t in enumerate(got):
            if t is not None:
                assert torch.equal(t, want[s * zl:(s + 1) * zl]), s
                checked += 1
    assert checked == 4 * SHARDS_PER_PROCESS, checked
    print(f"proc {rank}: sharded frangi bitwise across the process boundary "
          f"({checked} shards checked)", flush=True)


def case_seeds(rank, mesh):
    import torch

    import pnr_tpu_torch.parallel.multihost as mh
    import pnr_tpu_torch.pipeline.sharded_reconstruct as sr
    from pnr_tpu_torch.parallel import frangi3d_sharded, normalize_to_u8_sharded
    from pnr_tpu_torch.seeds.extract import decode_directions_device, max_points_host

    cfg = MP_CFG
    vol = mp_phantom()
    span = vol.shape[0]
    vs = mh.shard_volume_global(sr._pad_z_replicate(vol, mesh.size), mesh)
    j, jmin, jmax, vx, vy, vz = frangi3d_sharded(vs, cfg.sigmas, cfg.zdist, mesh, cfg.frangi_alpha,
                                                 cfg.frangi_beta, cfg.frangi_c)
    j8 = normalize_to_u8_sharded(j, jmin, jmax)

    fetch, exchange = mh.fetch_replicated, mh.exchange

    def guarded_fetch(shards, extent=None):
        raise AssertionError("a gather of sharded maps inside the per-shard seed stage")

    def guarded_exchange(obj):
        n = len(pickle.dumps(obj))
        if n >= vol.size:
            raise AssertionError(f"a volume-sized payload ({n} bytes) inside the per-shard "
                                 "seed stage: no process may gather J8 or a direction map")
        return exchange(obj)

    sr.fetch_replicated = mh.fetch_replicated = guarded_fetch
    sr.exchange = mh.exchange = guarded_exchange
    try:
        pos, dirs = sr._seeds_per_shard_multiprocess(j8, vx, vy, vz, cfg.tolerance, span)
    finally:
        sr.fetch_replicated = mh.fetch_replicated = fetch
        sr.exchange = mh.exchange = exchange

    # the single-device reference: the host flood on the gathered J8
    j8_full = fetch(j8, span)
    zz, yy, xx = np.nonzero(max_points_host(j8_full, cfg.tolerance))
    ref_pos = np.stack([xx, yy, zz], axis=-1).astype(np.float32)
    assert len(ref_pos) > 0, "the phantom gave no seeds: the case would prove nothing"
    np.testing.assert_array_equal(pos, ref_pos)
    maps = [torch.from_numpy(fetch(a)) for a in (vx, vy, vz)]
    np.testing.assert_array_equal(dirs, decode_directions_device(*maps, ref_pos))
    print(f"proc {rank}: per-shard seeds OK ({len(pos)} seeds, no volume-sized gather)",
          flush=True)


def case_pipeline(rank, mesh, out):
    import pnr_tpu_torch.pipeline.sharded_reconstruct as sr
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    # one checkpoint writer (rank 0); every process resumes from its file
    ck = out[:-len(".npz")] + "_ck.npz"
    if rank != 0:
        def refuse(*a, **k):
            raise AssertionError(f"rank {rank} wrote a checkpoint")

        sr.save_checkpoint = refuse
    res = reconstruction_func_sharded(mp_phantom(), MP_CFG, mesh, verbose=False)
    assert len(res.n0) > 2 and len(res.tree) > 2
    cut = reconstruction_func_sharded(mp_phantom(), dataclasses.replace(MP_CFG, max_trace_count=1),
                                      mesh, verbose=False, checkpoint_path=ck)
    assert cut.trace_count < res.trace_count
    assert os.path.exists(ck)  # rank 0 wrote it before the run's last exchange
    again = reconstruction_func_sharded(mp_phantom(), MP_CFG, mesh, verbose=False,
                                        checkpoint_path=ck, resume=True)
    assert again.trace_count == res.trace_count and np.array_equal(again.n0.positions(),
                                                                   res.n0.positions())
    try:
        reconstruction_func_sharded(mp_phantom(), MP_CFG, mesh, verbose=False,
                                    checkpoint_path=ck + ".missing", resume=True)
        raise AssertionError("a resume without its checkpoint went on")
    except FileNotFoundError as e:
        assert f"process {rank}" in str(e)
    res2 = reconstruction_func_sharded(mp_phantom_2d(), MP_CFG_2D, mesh, verbose=False)
    assert len(res2.tree) > 2
    if rank == 0:
        np.savez(
            out, x=np.asarray(res.n0.x), y=np.asarray(res.n0.y), z=np.asarray(res.n0.z),
            sig=np.asarray(res.n0.sig), ntype=np.asarray(res.n0.type), tree_n=len(res.tree),
            trace_count=res.trace_count, j8=res.j8, n_handoffs=res.n_handoffs,
            received=sum(res.received_bytes.values()), tree_n_2d=len(res2.tree),
            x_2d=np.asarray(res2.n0.x), y_2d=np.asarray(res2.n0.y), j8_2d=res2.j8,
            trace_count_2d=res2.trace_count,
        )
    print(f"proc {rank}: full sharded pipeline OK |n0|={len(res.n0)} |tree|={len(res.tree)} "
          f"traces={res.trace_count} |tree2d|={len(res2.tree)}", flush=True)


def main(argv):
    case, rank, port = argv[0], int(argv[1]), argv[2]
    import torch

    torch.set_num_threads(1)
    from pnr_tpu_torch.parallel.multihost import init_multihost, make_global_mesh, \
        shutdown_multihost

    assert init_multihost(f"localhost:{port}", 2, rank, backend="gloo") == rank
    try:
        mesh = make_global_mesh(device=("cpu",) * SHARDS_PER_PROCESS)
        assert mesh.size == 2 * SHARDS_PER_PROCESS and mesh.multiprocess
        assert mesh.ranks == (0,) * SHARDS_PER_PROCESS + (1,) * SHARDS_PER_PROCESS
        if case == "frangi":
            case_frangi(rank, mesh)
        elif case == "seeds":
            case_seeds(rank, mesh)
        elif case == "pipeline":
            case_pipeline(rank, mesh, argv[3])
        else:
            raise SystemExit(f"unknown case {case!r}")
    finally:
        shutdown_multihost()


if __name__ == "__main__":
    main(sys.argv[1:])
