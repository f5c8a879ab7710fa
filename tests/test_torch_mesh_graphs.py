"""The mesh tracers at JAX's stage shapes and through the stage-graph
runner's protocol (pnr_tpu_torch/parallel/batch_dp.py,
pnr_tpu_torch/parallel/handoff.py, pnr_tpu_torch/smc/graphs.py), on the
CPU.

(a) Batch DP's lockstep waves run JAX's shapes: each stack's 2 * wave_size
lanes (the pad lanes dead from the start) and every stage STAGE_ITERS
iterations. Their real lanes are bitwise what the unpadded stages give
when the last stage runs only the iterations below ni, and every stage
tracks `pnr_tpu`'s jitted batch tracer (`build_batch_tracer`) fed the
same lanes, keys and kill masks (exact mode, where both trace the volume
itself) at tests/test_torch_tracker.py's bar.
(b) The handoff stage traces all its lanes with the free ones killed: its
live lanes are bitwise what the old sub-batch of live lanes gives (the
sharded pipeline's stages, both modes), and the one-shot handoff step
tracks `pnr_tpu`'s (exact mode).
(c) Batch DP and the sharded pipeline driven through a recording runner
(the runner's protocol on the CPU: `load`, `buffers`, `writing`, `stage`,
each stage run eagerly on the runner's buffers) are bitwise the eager
loops, with one key per stack or shard, each shard's frame passed and
every runner dropped at the end.
(d) The launch bookkeeping: on both routes the tracer launches its
likelihood kernel twice a `trace_init` and 2 x STAGE_ITERS a stage and the
draws' kernel once each (what a capture takes back and each replay adds),
and the runners replay the eager loop's stages one for one.

The graphs themselves need a card: tests/test_torch_kernels.py
(`-k "graphs and mesh"`).
"""

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from _torch_once import once
from pnr_tpu.config import PNRConfig as JaxConfig
from pnr_tpu.parallel import make_mesh as jax_make_mesh
from pnr_tpu.parallel import shard_volume as jax_shard_volume
from pnr_tpu.parallel.batch_dp import build_batch_fields, build_batch_tracer
from pnr_tpu.parallel.handoff import build_handoff_trace_step as jax_handoff_step
from pnr_tpu.smc.tracker import BatchedTracker as JaxTracker
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.ops import threefry, tube_corr, zncc_exact
from pnr_tpu_torch.ops.slab import SlabFrame
from pnr_tpu_torch.parallel import (
    batch_dp,
    build_handoff_trace_step,
    make_mesh,
    reconstruction_batch_dp,
    shard_volume,
    stitch_estimates,
)
from pnr_tpu_torch.pipeline import reconstruction_func_sharded
from pnr_tpu_torch.smc import graphs
from pnr_tpu_torch.smc.tracker import BatchedTracker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: tests/test_torch_batch_dp.py's config at a wave of 3 seeds (8 lanes)
DP_CFG = dict(sigmas=(2.0,), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=14, np=8,
              zdist=2.0, nodepervol=4, vol=9, wave_size=4, fused_frangi=False)
#: batch DP's stages, short so that a wave runs several (the last past ni)
DP_STAGE = 4
#: tests/test_torch_sharded_pipeline.py's exact config at one sigma and a wave of 8 seeds
SHARD_CFG = dict(sigmas=(2.0,), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=16,
                 np=10, zdist=2.0, nodepervol=4, vol=9, wave_size=8, fused_frangi=False)


def dp_stacks(seed=31, n=2, shape=(8, 32, 64)):
    """tests/test_torch_batch_dp.py's batch stacks: a tube at y = 16 + 2k."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        d2 = (y - 16 - 2 * k) ** 2 + ((z - 4) * 2.0) ** 2
        out.append(np.clip(200.0 * np.exp(-d2 / (2 * 2.5**2)) * (x > 5) * (x < 58)
                           + rng.normal(0, 5, shape), 0, 255).astype(np.uint8))
    return out


def shard_volume_np(shape=(16, 40, 80), seed=11):
    """tests/test_torch_sharded_pipeline.py's stack."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] // 2) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    v = (200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
         * (x > 6) * (x < shape[2] - 7))
    return np.clip(v + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


def same_result(a, b):
    """Bitwise equal trees, node graphs and trace counts."""
    assert a.trace_count == b.trace_count > 0
    for na, nb in ((a.tree, b.tree), (a.n0, b.n0)):
        assert len(na) == len(nb) > 1 and na.nbr == nb.nbr
        for f in ("x", "y", "z", "sig", "corr", "type"):
            assert np.array_equal(np.asarray(getattr(na, f)), np.asarray(getattr(nb, f))), f


# -- (a) batch DP at JAX's shapes ------------------------------------------------


def _record_batch_dp(mode):
    """`reconstruction_batch_dp` of two stacks on a two-shard CPU mesh at
    STAGE_ITERS DP_STAGE, each stack's waves recorded: per lockstep round
    and stack its lanes' inputs, keys, the real lane count, the field, and
    per stage its first iteration, kill mask and packed estimates."""
    cfg = PNRConfig(**DP_CFG, zncc_mode=mode)
    rounds = []

    class Recorded(batch_dp._StackWave):
        def __init__(self, tracker, field, committer, pos, dirs, sel, *rest):
            super().__init__(tracker, field, committer, pos, dirs, sel, *rest)
            stack = id(field)
            if not rounds or stack in rounds[-1]:
                rounds.append({})
            self.rec = rounds[-1][stack] = {
                "pos": pos[sel], "dirs": dirs[sel], "t_real": self.t_real,
                "keys": self.keys.numpy().copy(), "field": field.numpy().copy(),
                "est0": self._est0.numpy().copy(), "stages": []}

        def launch(self, it0):
            fetch = super().launch(it0)
            if fetch is not None:
                self.rec["stages"].append((it0, self.killed.copy(), fetch().copy()))
            return fetch

    real = (batch_dp._StackWave, batch_dp.BatchedTracker)
    batch_dp._StackWave = Recorded
    batch_dp.BatchedTracker = functools.partial(BatchedTracker, stage_iters=DP_STAGE)
    try:
        res = reconstruction_batch_dp(dp_stacks(), cfg, make_mesh(2, device="cpu"),
                                      device="cpu")
    finally:
        batch_dp._StackWave, batch_dp.BatchedTracker = real
    order = {}
    for r in rounds:  # stacks by first appearance
        for k in r:
            order.setdefault(k, len(order))
    rounds = [{order[k]: v for k, v in r.items()} for r in rounds]
    return {"rounds": rounds, "traces": [r.trace_count for r in res]}


def dp_record(tmp_path_factory, mode):
    return mode, once(tmp_path_factory, f"mesh_graphs_dp_{mode}",
                      lambda: _record_batch_dp(mode))


def _lanes(rec, lanes):
    """A recorded wave's lane inputs as `_StackWave` builds them."""
    t = rec["t_real"]
    sp = np.zeros((lanes, 3), np.float32)
    sd = np.zeros((lanes, 3), np.float32)
    sd[:, 0] = 1.0
    sp[:t] = np.repeat(rec["pos"], 2, axis=0)
    sd[0:t:2] = rec["dirs"]
    sd[1:t:2] = -rec["dirs"]
    return sp, sd


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_batch_dp_padded_full_stages_are_the_variable_shape_stages(tmp_path_factory, mode):
    """Every stack's wave has 2 * wave_size lanes, its pad lanes killed from
    the start, and every stage DP_STAGE iterations, the last past ni. The
    real lanes' estimates are bitwise the unpadded wave's: its `trace_init`,
    and its stages under the same kill masks with the last one cut at ni
    (the shapes batch DP ran before)."""
    mode, got = dp_record(tmp_path_factory, mode)
    cfg = PNRConfig(**DP_CFG, zncc_mode=mode)
    lanes = 2 * cfg.wave_size
    tracker = BatchedTracker(cfg, "cpu", stage_iters=DP_STAGE)
    waves = [rec for r in got["rounds"] for rec in r.values()]
    assert len(got["rounds"]) >= 2 and sum(got["traces"]) > 0
    assert any(rec["t_real"] < lanes for rec in waves)
    past_ni = 0
    for rec in waves:
        t = rec["t_real"]
        field = torch.from_numpy(rec["field"])
        sp, sd = _lanes(rec, lanes)
        keys = torch.from_numpy(rec["keys"][:t])
        assert rec["keys"].shape == (lanes, 2)
        carry, est0 = tracker.trace_init(field, sp[:t], sd[:t], keys)
        assert np.array_equal(est0.numpy(), rec["est0"][:t])
        its = [it0 for it0, _, _ in rec["stages"]]
        assert its == list(range(1, 1 + DP_STAGE * len(its), DP_STAGE))
        for it0, kill, packed in rec["stages"]:
            assert packed.shape == (lanes, DP_STAGE, 9) and kill[t:].all()
            n = min(DP_STAGE, cfg.ni - it0)
            past_ni += n < DP_STAGE
            carry, want = tracker.trace_stage(field, keys, carry, it0, n,
                                              torch.from_numpy(kill[:t].copy()))
            assert np.array_equal(want.numpy(), packed[:t, :n]), it0
    assert past_ni > 0


def test_batch_dp_stages_track_jax_batch_tracer(tmp_path_factory):
    """Each lockstep round through `pnr_tpu`'s jitted batch tracer on a
    two-device mesh, fed the port's lanes, keys (their uint32 bits) and
    valid flags, and at each stage the port's kill masks (every lane killed
    for a stack the port did not launch): the real lanes' estimates, rows
    past ni included, at tests/test_torch_tracker.py's bar (every column
    within 1e-3, sigma and valid equal), and no pad lane valid. Exact
    mode: the field is the volume in both packages (tube mode builds its
    maps in each)."""
    mode, got = dp_record(tmp_path_factory, "exact")
    cfg = JaxConfig(**DP_CFG, zncc_mode=mode)
    lanes = 2 * cfg.wave_size
    jmesh = jax_make_mesh(2)
    jt = JaxTracker(cfg, False)
    vols = np.stack(dp_stacks())
    fields = build_batch_fields(jt, jmesh)(
        jax.device_put(jnp.asarray(vols), NamedSharding(jmesh, P(jmesh.axis_names[0]))))
    init, stage = build_batch_tracer(jt, cfg, jmesh, lanes)
    checked = 0
    for rnd in got["rounds"]:
        sp = np.zeros((2, lanes, 3), np.float32)
        sd = np.zeros((2, lanes, 3), np.float32)
        sd[..., 0] = 1.0
        kd = np.zeros((2, lanes, 2), np.uint32)
        valid = np.zeros((2, lanes), bool)
        for i, rec in rnd.items():
            assert np.array_equal(rec["field"], vols[i])
            sp[i], sd[i] = _lanes(rec, lanes)
            kd[i] = rec["keys"].view(np.uint32)
            valid[i, :rec["t_real"]] = True
        carry, est0 = init(fields, jnp.asarray(sp.reshape(-1, 3)), jnp.asarray(sd.reshape(-1, 3)),
                           jnp.asarray(kd.reshape(-1, 2)), jnp.asarray(valid.reshape(-1)))
        est0 = np.asarray(est0).reshape(2, lanes, 9)
        for i, rec in rnd.items():
            t = rec["t_real"]
            assert_tracks(rec["est0"][:t], est0[i, :t])
        stages = {i: dict((it0, (k, p)) for it0, k, p in rec["stages"]) for i, rec in rnd.items()}
        for it0 in sorted({it for s in stages.values() for it in s}):
            kill = np.ones((2, lanes), bool)
            for i, s in stages.items():
                if it0 in s:
                    kill[i] = s[it0][0]
            carry, packed = stage(fields, carry, jnp.asarray(kd.reshape(-1, 2)),
                                  jnp.arange(it0, it0 + DP_STAGE), jnp.asarray(kill.reshape(-1)))
            packed = np.asarray(packed).reshape(2, lanes, DP_STAGE, 9)
            for i, s in stages.items():
                if it0 in s:
                    t = rnd[i]["t_real"]
                    assert_tracks(s[it0][1][:t], packed[i, :t])
                    assert not s[it0][1][t:, :, 8].any()
                    checked += 1
    assert checked >= 4


def assert_tracks(got, want):
    """tests/test_torch_tracker.py's bar."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    for col in (6, 8):
        assert np.array_equal(got[..., col], want[..., col])


# -- (b) the handoff stage over all its lanes --------------------------------------


def recording_stages(monkeypatch):
    """Record every eager `trace_stage`: the tracker, field, frame, it0,
    n_it, the inputs (keys, carry, kill) and outputs (carry, packed), copied
    (the handoff writes its carries in place afterwards)."""
    log = []
    real = BatchedTracker.trace_stage

    def rec(self, field, keys, carry, it0, n_it, kill, frame=None):
        ins = (keys.clone(), tuple(c.clone() for c in carry), kill.clone())
        out, packed = real(self, field, keys, carry, it0, n_it, kill, frame)
        log.append((self, field, frame, it0, n_it, ins, tuple(c.clone() for c in out),
                    packed.clone()))
        return out, packed

    monkeypatch.setattr(BatchedTracker, "trace_stage", rec)
    return log, real


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_handoff_stage_over_all_lanes_is_the_live_sub_batch(mode, monkeypatch):
    """The sharded pipeline on four CPU shards: every stage traces all of
    a shard's 2 * wave_size lanes, the free ones killed, at stage_iters
    iterations under the shard's frame; its live lanes' estimates and
    carries are bitwise those of the live lanes alone (the sub-batch the
    handoff traced before), and the run hands traces off."""
    log, real = recording_stages(monkeypatch)
    cfg = PNRConfig(**{**SHARD_CFG, "ni": 12}, zncc_mode=mode)
    res = reconstruction_func_sharded(shard_volume_np(), cfg, make_mesh(4, device="cpu"),
                                      verbose=False, stage_iters=4)
    assert res.n_handoffs > 0 and res.n_lost == 0 and log
    lanes = 2 * cfg.wave_size
    partial = 0
    for tracker, field, frame, it0, n_it, (keys, carry, kill), out, packed in log:
        assert isinstance(frame, SlabFrame) and n_it == 4 and len(kill) == lanes
        idx = torch.nonzero(~kill)[:, 0]
        partial += 0 < len(idx) < lanes
        sub = tuple(c.index_select(0, idx) for c in carry)
        want_c, want = real(tracker, field, keys.index_select(0, idx), sub, it0, n_it,
                            torch.zeros(len(idx), dtype=torch.bool), frame)
        assert torch.equal(packed.index_select(0, idx), want), it0
        for a, b in zip(out, want_c):
            assert torch.equal(a.index_select(0, idx), b)
        assert not packed[kill][:, :, 8].any()
    assert partial > 0


def spanning_volume():
    """tests/test_torch_sharded.py's volume: a tube along z."""
    rng = np.random.default_rng(9)
    shape = (32, 24, 64)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - 12) ** 2 + (x - 32) ** 2
    return np.clip(200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.75 + 0.25 * np.sin(z / 3.0))
                   + rng.normal(0, 4, shape), 0, 255).astype(np.uint8)


def test_handoff_step_tracks_jax():
    """The one-shot handoff step (every stage at stage_iters iterations,
    the rows past ni invalid) on four shards against `pnr_tpu`'s on the
    same volume, seeds, ids and key: the same lanes every stage, and the
    stitched traces at tests/test_torch_tracker.py's bar where valid."""
    vol = spanning_volume()
    kw = dict(sigmas=(2.0,), znccth=0.3, kappa=2.0, step=2, ni=15, np=8, zdist=1.0,
              nodepervol=4, vol=9)
    lanes, stage_iters, n = 4, 3, 4
    sp = np.zeros((n * lanes, 3), np.float32)
    sd = np.zeros((n * lanes, 3), np.float32)
    valid = np.zeros(n * lanes, bool)
    for s, (z, d) in enumerate(((2.0, 1.0), (10.0, 1.0), (21.0, -1.0), (29.0, -1.0))):
        sp[s * lanes], sd[s * lanes, 2], valid[s * lanes] = (32.0, 12.0, z), d, True
    ids = np.arange(n * lanes)
    step, _, _ = build_handoff_trace_step(PNRConfig(**kw), make_mesh(n, device="cpu"), lanes,
                                          stage_iters)
    packs, sids, _, lost = step(shard_volume(vol, make_mesh(n, device="cpu")), sp, sd, ids,
                                valid, tf.key_from_seed(0))
    jmesh = jax_make_mesh(n)
    jstep, _, _ = jax_handoff_step(JaxConfig(**kw), jmesh, lanes, stage_iters)
    want = [np.asarray(a) for a in jstep(jax_shard_volume(vol, jmesh), sp, sd, ids, valid,
                                         jax.random.key(0))]
    assert packs.shape == want[0].shape and not lost.any()
    assert np.array_equal(sids, want[1])
    shards = {int(np.nonzero(row == 0)[0][0]) // lanes for row in sids if (row == 0).any()}
    assert len(shards) >= 2, "no trace was handed off"
    est, tids = stitch_estimates(packs, sids, kw["ni"])
    est_j, tids_j = stitch_estimates(want[0], want[1], kw["ni"])
    assert np.array_equal(tids, tids_j)
    ok = est[:, :, 8] > 0.5
    assert ok.sum() > 10 and np.array_equal(ok, est_j[:, :, 8] > 0.5)
    assert_tracks(np.where(ok[..., None], est, 0), np.where(ok[..., None], est_j, 0))


# -- (c), (d) the mesh loops through a recording runner -----------------------------


class MeshRunner:
    """The stage-graph runner's protocol on the CPU: `load` copies a slot's
    carry and keys into its buffers, a caller writes them between stages
    inside `writing`, and `stage` runs `trace_stage` eagerly on them at
    STAGE_ITERS under the runner's frame, updating them in place; each
    stage's key and route are recorded."""

    def __init__(self, tracker, field, frame):
        self.tracker, self.field, self.frame = tracker, field, frame
        self.plan = graphs.StagePlan()
        self.slots, self.log = {}, []
        self.writes = self.dropped = 0

    def load(self, slot, carry, keys):
        t = len(keys)
        if (slot, t) not in self.slots:
            self.slots[(slot, t)] = (tuple(torch.empty_like(c) for c in carry),
                                     torch.empty_like(keys))
        bc, bk = self.slots[(slot, t)]
        for dst, src in zip(bc + (bk,), carry + (keys,)):
            dst.copy_(src)

    def buffers(self, slot, t):
        return self.slots[(slot, t)]

    @contextlib.contextmanager
    def writing(self):
        self.writes += 1
        yield

    def stage(self, slot, it0, kill):
        carry, keys = self.slots[(slot, len(kill))]
        n_it = self.tracker.STAGE_ITERS
        key = (slot, len(kill), n_it)
        self.log.append((key, self.plan.route(key)))
        out, packed = self.tracker.trace_stage(self.field, keys, carry, it0, n_it,
                                               torch.from_numpy(kill.copy()), self.frame)
        for dst, src in zip(carry, out):
            dst.copy_(src)
        return types.SimpleNamespace(numpy=packed.numpy)


def counted_run(run, monkeypatch, through_runner):
    """`run()` eagerly or through MeshRunners (one per field), with the
    tracer's launches tallied on this thread (`tally_launch`: the
    likelihood's and the draws' kernels) and its `trace_init` and stage
    calls counted. Returns (result, tally, inits, stage iteration counts,
    runners)."""
    runners = {}
    calls = {"inits": 0, "stages": []}
    init, stage = BatchedTracker.trace_init, BatchedTracker.trace_stage

    def counted_init(self, *a, **k):
        calls["inits"] += 1
        return init(self, *a, **k)

    def counted_stage(self, field, keys, carry, it0, n_it, *a, **k):
        calls["stages"].append(n_it)
        return stage(self, field, keys, carry, it0, n_it, *a, **k)

    def stage_graphs(self, field, frame=None):
        return runners.setdefault(id(field), MeshRunner(self, field, frame))

    def drop(self, field):
        if id(field) in runners:
            runners[id(field)].dropped += 1

    with monkeypatch.context() as m:
        m.setattr(BatchedTracker, "trace_init", counted_init)
        m.setattr(BatchedTracker, "trace_stage", counted_stage)
        if through_runner:
            m.setattr(BatchedTracker, "stage_graphs", stage_graphs)
            m.setattr(BatchedTracker, "drop_stage_graphs", drop)
        graphs._TALLY.counts = tally = {}
        try:
            res = run()
        finally:
            graphs._TALLY.counts = None
    return res, tally, calls["inits"], calls["stages"], list(runners.values())


def check_launches(tally, inits, stages, counter, stage_iters):
    """Two likelihood launches a `trace_init` and 2 x STAGE_ITERS a stage,
    one draw each; every stage at STAGE_ITERS."""
    assert inits > 0 and stages and set(stages) == {stage_iters}
    assert tally == {counter: 2 * inits + 2 * stage_iters * len(stages),
                     (threefry, "LAUNCHES"): inits + len(stages)}


def check_runners(runners, n, t, stage_iters, stages):
    """One key a runner, captured at its first stage and replayed after (a
    shard whose lanes never held a live trace has no stage); the runners'
    stages are the eager loop's, one for one; every runner dropped."""
    assert len(runners) == n
    for r in runners:
        routes = [route for key, route in r.log]
        assert {key for key, _ in r.log} <= {(0, t, stage_iters)}
        assert routes == [graphs.CAPTURE] * bool(routes) + [graphs.REPLAY] * (len(routes) - 1)
        assert r.dropped == 1
    assert sum(len(r.log) for r in runners) == len(stages)
    return sum(bool(r.log) for r in runners)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_batch_dp_through_a_runner_is_bitwise_eager(mode, monkeypatch):
    """Three stacks on a two-shard CPU mesh (two groups): through one
    recording runner a stack (no frame), bitwise the eager loop's trees,
    node graphs and trace counts; one key (0, 2 * wave_size, STAGE_ITERS) a
    stack; the launches of (d) on both routes, and equal."""
    cfg = PNRConfig(**DP_CFG, zncc_mode=mode)
    vols = dp_stacks(n=3)
    counter = (tube_corr, "TRACE_LAUNCHES") if mode == "tube" else (zncc_exact, "LAUNCHES")
    runs = [counted_run(lambda: reconstruction_batch_dp(vols, cfg, make_mesh(2, device="cpu"),
                                                        device="cpu"), monkeypatch, through)
            for through in (False, True)]
    (eager, t_e, i_e, s_e, no_runners), (got, t_g, i_g, s_g, runners) = runs
    assert not no_runners
    for a, b in zip(got, eager):
        same_result(a, b)
    stage_iters = 16 if mode == "tube" else 8
    for tally, inits, stages in ((t_e, i_e, s_e), (t_g, i_g, s_g)):
        check_launches(tally, inits, stages, counter, stage_iters)
    assert (t_g, i_g, s_g) == (t_e, i_e, s_e)
    assert check_runners(runners, 3, 2 * cfg.wave_size, stage_iters, s_g) == 3
    assert all(r.frame is None and r.writes == 0 for r in runners)


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_sharded_wave_loop_through_a_runner_is_bitwise_eager(mode, monkeypatch):
    """The sharded pipeline on four CPU shards through one recording runner a
    shard, each made with its shard's frame (`build_fields`'): bitwise the eager run's tree,
    node graph, trace count and handoffs; one key (0, lanes, stage_iters) a
    shard; the carries and keys written only inside `writing`; the
    launches of (d) on both routes, and equal."""
    from pnr_tpu_torch.pipeline import sharded_reconstruct

    cfg = PNRConfig(**{**SHARD_CFG, "ni": 12}, zncc_mode=mode)
    vol = shard_volume_np()
    counter = (tube_corr, "TRACE_LAUNCHES") if mode == "tube" else (zncc_exact, "LAUNCHES")
    built = []
    build = sharded_reconstruct.build_fields

    def build_fields(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    monkeypatch.setattr(sharded_reconstruct, "build_fields", build_fields)
    runs = [counted_run(lambda: reconstruction_func_sharded(
                vol, cfg, make_mesh(4, device="cpu"), verbose=False, stage_iters=4),
                monkeypatch, through) for through in (False, True)]
    (eager, t_e, i_e, s_e, _), (got, t_g, i_g, s_g, runners) = runs
    same_result(got, eager)
    assert got.n_handoffs == eager.n_handoffs > 0 and got.n_kept_local == eager.n_kept_local
    for tally, inits, stages in ((t_e, i_e, s_e), (t_g, i_g, s_g)):
        check_launches(tally, inits, stages, counter, 4)
    assert (t_g, i_g, s_g) == (t_e, i_e, s_e)
    assert check_runners(runners, 4, 2 * cfg.wave_size, 4, s_g) >= 2
    frames = {id(f): frame for f, frame in built[-1]}
    assert all(isinstance(r.frame, SlabFrame) and r.frame == frames[id(r.field)]
               for r in runners)
    assert all(r.writes > 0 for r in runners)


def test_exact_plain_samples_a_nan_query_as_k2_clamps_it():
    """A dead lane may carry NaN (JAX's one-shot pads seeds with a zero
    direction): K2's plain version floors a NaN sample coordinate at 0 as
    the kernel's `fmaxf` does, where a clamp would pass the NaN on to a
    gather index; the other queries are unchanged."""
    from pnr_tpu_torch.ops.zncc_exact import ExactPatchEngine
    from pnr_tpu_torch.ops.zncc_model import ZnccTemplates

    vol = torch.from_numpy(dp_stacks(n=1)[0])
    eng = ExactPatchEngine(ZnccTemplates((2.0,), False), 2, "cpu")
    pos = torch.tensor([[[20.0, 16.0, 4.0]] * 3, [[30.0, 16.0, 4.0]] * 3])
    d = torch.tensor([[[1.0, 0.0, 0.0]] * 3] * 2)
    corner = eng.corners(vol.shape, pos.mean(dim=1))
    want = eng.corr(vol, corner, pos, d)
    bad = d.clone()
    bad[1] = float("nan")
    got = eng.corr(vol, corner, pos, bad)
    assert torch.equal(got[0][0], want[0][0]) and torch.equal(got[1][0], want[1][0])
    assert got[0].shape == want[0].shape
