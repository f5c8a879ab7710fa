"""The single-stack tracer's stage split and the host side of its stage-graph
runner (pnr_tpu_torch/smc/graphs.py), on the CPU: the stage's iterations
(`_stage_iters`) fed the host draws of `stage_uniforms` are bitwise
`trace_stage`, which draws on the device route (itself held to the JAX
tracer in tests/test_torch_tracker.py); the wave loop's JAX shapes (chunks padded
to TRACE_CHUNK, every stage STAGE_ITERS iterations) give bitwise the
unpadded wave's real-lane estimates and track `pnr_tpu`'s wave;
`StagePlan`'s routes over the main stack's two waves; the wave loop
through a runner's protocol (`join_warm`, `load`, `stage`, `finish`) is
bitwise the eager wave; `warm_async`'s switches and its thread's failure;
the gate that holds warm captures while a batch's caller runs; the launch
bookkeeping of captures and replays. The graphs themselves
need a card: tests/test_torch_kernels.py (`-k graphs`)."""

import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.graph.nodes import NodeList
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.ops import tube_corr, zncc_exact
from pnr_tpu_torch.pipeline import reconstruct
from pnr_tpu_torch.smc import graphs
from pnr_tpu_torch.ops import threefry
from pnr_tpu_torch.smc.tracker import BatchedTracker, trace_keys

# one sigma and few particles keep the exact engine's plain sums cheap
CFG = PNRConfig(sigmas=(2.0,), znccth=0.3, kappa=3.0, step=2, ni=20, np=3, zdist=2.0,
                nodepervol=4, vol=9)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tube_volume(shape=(12, 36, 48), seed=11):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] // 2) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    return np.clip(
        200.0 * np.exp(-d2 / (2 * 3.0**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
        + rng.normal(0, 5, x.shape),
        0, 255,
    ).astype(np.uint8)


def seeds_on_the_axis(n, seed=0, shape=(12, 36, 48)):
    rng = np.random.default_rng(seed)
    sp = np.stack([rng.uniform(6, shape[2] - 6, n), rng.normal(shape[1] // 2, 1.5, n),
                   rng.normal(shape[0] // 2, 0.7, n)], -1).astype(np.float32)
    sd = np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1))
    sd[1::2, 0] = -1.0
    return sp, sd


def tracker_and_field(mode, ni=CFG.ni, **kw):
    cfg = dataclasses.replace(CFG, zncc_mode=mode, ni=ni)
    tracker = BatchedTracker(cfg, "cpu", **kw)
    return tracker, tracker.prepare_field(torch.from_numpy(tube_volume()))


@pytest.mark.parametrize("mode,t,n_it", [("exact", 128, 3), ("exact", 37, None),
                                         ("tube", 128, 3), ("tube", 37, None)])
def test_stage_body_fed_stage_uniforms_is_trace_stage(mode, t, n_it):
    """Two stages after `trace_init`, the second with a kill mask that
    retires every third trace: the stage's iterations (`_stage_iters`) on
    the host draws of `stage_uniforms` give `trace_stage`'s carry and
    packed estimates (drawn on the device route) bit for bit (n_it None:
    the tracker's STAGE_ITERS)."""
    tracker, field = tracker_and_field(mode)
    n_it = n_it or tracker.STAGE_ITERS
    sp, sd = seeds_on_the_axis(t)
    keys = trace_keys(tf.key_from_seed(3), np.arange(t))
    kills = [torch.zeros(t, dtype=torch.bool), torch.from_numpy(np.arange(t) % 3 == 0)]
    carry0, _ = tracker.trace_init(field, sp, sd, keys)
    runs = []
    for body in (False, True):
        carry, packs = carry0, []
        for k, kill in enumerate(kills):
            it0 = 1 + k * n_it
            if body:
                u1, ru = (torch.from_numpy(a)
                          for a in tf.stage_uniforms(keys, it0, n_it, tracker.cfg.np))
                carry, packed = tracker._stage_iters(field, carry, u1, ru, kill, n_it)
            else:
                carry, packed = tracker.trace_stage(field, keys, carry, it0, n_it, kill)
            packs.append(packed)
        runs.append((carry, packs))
    (ca, pa), (cb, pb) = runs
    assert pa[0].shape == (t, n_it, 9)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert all(torch.equal(a, b) for a, b in zip(ca, cb))
    # the kill mask retired its traces in the second stage
    assert not pa[1][::3, :, 8].any() and pa[1][:, 0, 8].any()


def main_stack_wave_keys(n_traces, ni, stage, chunk=128):
    """The keys (slot, T, n_it) `_trace_and_commit_wave` dispatches for a
    wave of n_traces traces that runs to its last iteration, in order:
    JAX's shapes, whole chunks of `chunk` traces and full stages."""
    slots = -(-n_traces // chunk)
    return [(c, chunk, stage) for _ in range(1, ni, stage) for c in range(slots)]


@pytest.mark.parametrize("mode,stage", [("exact", 8), ("tube", 16)])
def test_plan_over_the_main_stacks_two_waves(mode, stage):
    """The main stack at ni 100 (`-p 2,4,6 0 10 0.5 3 2 100 20 2 4 9`):
    a wave of 256 traces (two slots of T=128), then one of 90 (padded to
    slot 0 at T=128). Two keys, each captured at its first stage and
    replayed at every later one, the second wave's stages included."""
    plan = graphs.StagePlan()
    routes = {}
    for n in (256, 90):
        for key in main_stack_wave_keys(n, 100, stage):
            routes.setdefault(key, []).append(plan.route(key))
    stages = -(-99 // stage)  # 13 exact, 7 tube
    assert routes == {
        (0, 128, stage): [graphs.CAPTURE] + [graphs.REPLAY] * (2 * stages - 1),
        (1, 128, stage): [graphs.CAPTURE] + [graphs.REPLAY] * (stages - 1),
    }


class Recorder:
    """Wraps a tracker's `trace_init` and `trace_stage` (the eager route)
    to note each call's inputs and estimates on the host."""

    def __init__(self, tracker):
        self.inits, self.stages = [], []
        init, stage = tracker.trace_init, tracker.trace_stage

        def trace_init(field, sp, sd, keys):
            carry, est0 = init(field, sp, sd, keys)
            self.inits.append((np.array(sp), np.array(sd), np.array(keys), est0.numpy().copy()))
            return carry, est0

        def trace_stage(field, keys, carry, it0, n_it, kill):
            carry, packed = stage(field, keys, carry, it0, n_it, kill)
            self.stages.append((np.array(keys), it0, n_it, kill.numpy().copy(),
                                packed.numpy().copy()))
            return carry, packed

        tracker.trace_init, tracker.trace_stage = trace_init, trace_stage


def run_wave(tracker, field, n_seeds, ni, seed=0):
    """One `_trace_and_commit_wave` of n_seeds seeds on the axis; returns
    the committer and the trace count."""
    shape = tube_volume().shape
    committer = reconstruct.TraceCommitter(shape, CFG.vol, CFG.nodepervol, NodeList(), None)
    sp, sd = seeds_on_the_axis(n_seeds, seed=seed)
    cfg = dataclasses.replace(tracker.cfg, ni=ni)
    count, _ = reconstruct._trace_and_commit_wave(
        tracker, committer, field, sp, sd, np.arange(n_seeds), tf.key_from_seed(1), cfg, 0)
    return committer, count


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_padded_full_width_wave_is_the_unpadded_wave_and_tracks_jax(mode):
    """A wave of 5 seeds (10 traces) in chunks of 8 at STAGE_ITERS 4, ni 10:
    JAX's shapes pad it to two chunks (the second has 6 pad lanes of seed
    0, id 0, killed from the start) and run every stage at 4 iterations,
    the last one past ni. (1) Each chunk's real lanes are bitwise what the
    unpadded chunk gives when its last stage runs only the iterations
    below ni, under the same kill masks. (2) `pnr_tpu`'s
    `_trace_and_commit_wave` with the same chunk, stage, seeds and keys
    dispatches the same stages with the same kill masks, and every
    estimate (pad lanes and rows past ni included) is within
    tests/test_torch_tracker.py's bar: 1e-3, sigma and valid equal."""
    import jax
    import jax.numpy as jnp
    from pnr_tpu.graph.build import TraceCommitter as JaxCommitter
    from pnr_tpu.graph.nodes import NodeList as JaxNodeList
    from pnr_tpu.pipeline.reconstruct import _trace_and_commit_wave as jax_wave
    from pnr_tpu.smc.tracker import BatchedTracker as JaxTracker
    from pnr_tpu_torch.ops.zncc_fast import field_from_numpy

    ni, chunk, stage, n_seeds = 10, 8, 4, 5
    cfg = dataclasses.replace(CFG, zncc_mode=mode, ni=ni)
    vol = tube_volume()
    jt = JaxTracker(cfg, False)
    jt.TRACE_CHUNK, jt.STAGE_ITERS = chunk, stage
    jfield = jt.prepare_field(jnp.asarray(vol))
    tracker = BatchedTracker(cfg, "cpu", trace_chunk=chunk, stage_iters=stage)
    field = (field_from_numpy(np.asarray(jfield), "cpu") if mode == "tube"
             else torch.from_numpy(vol))
    rec = Recorder(tracker)
    committer, count = run_wave(tracker, field, n_seeds, ni)
    assert count > 0 and len(rec.inits) == 2 and rec.stages
    assert all(keys.shape == (chunk, 2) and n_it == stage for keys, _, n_it, _, _ in rec.stages)
    real = [chunk, 2 * n_seeds - chunk]

    # (1) the unpadded chunk, its last stage cut at ni
    for c, (sp, sd, keys, est0) in enumerate(rec.inits):
        r = real[c]
        # the pad lanes: the wave's first trace (seed 0, positive direction)
        first = rec.inits[0][0][:1]
        assert np.array_equal(sp[r:], np.repeat(first, chunk - r, axis=0))
        carry, want0 = BatchedTracker.trace_init(tracker, field, sp[:r], sd[:r], keys[:r])
        assert np.array_equal(want0.numpy(), est0[:r])
        mine = [st for st in rec.stages if np.array_equal(st[0], keys)]
        assert [st[1] for st in mine] == list(range(1, 1 + stage * len(mine), stage))
        assert mine[-1][1] + stage > ni or c == 1
        for _, it0, _, kill, packed in mine:
            assert kill[r:].all()  # the pad lanes, from the start
            n = min(stage, ni - it0)
            carry, want = BatchedTracker.trace_stage(
                tracker, field, keys[:r], carry, it0, n, torch.from_numpy(kill[:r].copy()))
            assert np.array_equal(want.numpy(), packed[:r, :n]), (c, it0)

    # (2) pnr_tpu's wave on the same inputs
    j_inits, j_stages = [], []
    j_init, j_stage = jt._trace_init, jt._trace_stage

    def rec_init(f, sp, sd, keys):
        carry, est0 = j_init(f, sp, sd, keys)
        j_inits.append(np.asarray(est0))
        return carry, est0

    def rec_stage(f, keys, carry, iters, kill):
        carry, packed = j_stage(f, keys, carry, iters, kill)
        # a copy now: on the CPU the mask may alias the wave's `killed`
        j_stages.append((int(iters[0]), len(iters), np.array(kill), np.asarray(packed)))
        return carry, packed

    jt._trace_init, jt._trace_stage = rec_init, rec_stage
    shape = vol.shape
    jcommitter = JaxCommitter(shape, CFG.vol, CFG.nodepervol, JaxNodeList(), None)
    sp, sd = seeds_on_the_axis(n_seeds)
    jcount, _ = jax_wave(jt, jcommitter, jfield, sp, sd, np.arange(n_seeds), jax.random.key(1),
                         cfg, 0)
    assert jcount == count and len(jcommitter.nodes) == len(committer.nodes)
    assert len(j_inits) == len(rec.inits) and len(j_stages) == len(rec.stages)
    for want, (*_, got) in zip(j_inits, rec.inits):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        for col in (6, 8):
            assert np.array_equal(got[:, col], want[:, col])
    for (it0, n_it, kill, want), (_, it0_p, n_p, kill_p, got) in zip(j_stages, rec.stages):
        assert (it0, n_it) == (it0_p, n_p) and np.array_equal(kill, kill_p)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        for col in (6, 8):
            assert np.array_equal(got[..., col], want[..., col])


class RecordingRunner:
    """The runner's protocol on the CPU: each stage runs `trace_stage`
    eagerly on the loaded carry at STAGE_ITERS, and its key's route is
    recorded."""

    def __init__(self, tracker, field):
        self.tracker, self.field = tracker, field
        self.plan = graphs.StagePlan()
        self.carries, self.keys, self.log, self.finished, self.joined = {}, {}, [], 0, 0

    def join_warm(self):
        self.joined += 1

    def load(self, slot, carry, keys):
        self.carries[slot] = carry
        self.keys[slot] = keys

    def stage(self, slot, it0, kill):
        n_it = self.tracker.STAGE_ITERS
        key = (slot, len(kill), n_it)
        self.log.append((key, self.plan.route(key)))
        self.carries[slot], packed = self.tracker.trace_stage(
            self.field, self.keys[slot], self.carries[slot], it0, n_it,
            torch.from_numpy(kill.copy()))
        return types.SimpleNamespace(numpy=packed.numpy)

    def finish(self):
        self.finished += 1


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_wave_loop_through_a_runner_is_bitwise_eager(mode):
    """`_trace_and_commit_wave` through a runner (two waves: 16 traces in
    two slots of 8, then 10 padded to two slots of 8) commits bitwise what
    the eager wave commits; the wave joins the warm thread first and ends
    by calling `finish`; two keys, each captured at its first stage and
    replayed after, across both waves."""
    shape = (12, 36, 48)
    runs = []
    for through in (False, True):
        tracker, field = tracker_and_field(mode, ni=14, trace_chunk=8, stage_iters=4)
        runner = RecordingRunner(tracker, field) if through else None
        tracker.stage_graphs = lambda f: runner
        committer = reconstruct.TraceCommitter(shape, CFG.vol, CFG.nodepervol, NodeList(), None)
        count = 0
        for w, n in enumerate((8, 5)):
            sp, sd = seeds_on_the_axis(n, seed=w)
            count, _ = reconstruct._trace_and_commit_wave(
                tracker, committer, field, sp, sd, np.arange(n) + 8 * w, tf.key_from_seed(1),
                tracker.cfg, count)
        runs.append((committer.nodes, count, runner))
    (na, ca, _), (nb, cb, runner) = runs
    assert ca == cb > 0 and len(na) == len(nb) > 0
    for f in ("x", "y", "z", "sig", "corr", "type"):
        assert np.array_equal(np.asarray(getattr(na, f)), np.asarray(getattr(nb, f))), f
    assert runner.finished == runner.joined == 2
    by_key = {}
    for key, route in runner.log:
        by_key.setdefault(key, []).append(route)
    assert set(by_key) == {(0, 8, 4), (1, 8, 4)}
    for key, got in by_key.items():
        assert got == [graphs.CAPTURE] + [graphs.REPLAY] * (len(got) - 1), key
    assert all(len(got) > 3 for got in by_key.values())


def test_warm_async_switches(monkeypatch):
    """`warm_async` starts no thread on a CPU field, with `graphs=False`,
    or under PNR_TPU_NO_WARM_ASYNC=1 (JAX's switch), even where a runner
    exists."""
    for flag in (True, False):
        tracker, field = tracker_and_field("exact", graphs=flag)
        assert tracker.warm_async(field) is None
    started = []
    fake = types.SimpleNamespace(warm_started=False,
                                 start_warm=lambda *a: started.append(a))
    tracker, field = tracker_and_field("tube")
    monkeypatch.setattr(tracker, "stage_graphs", lambda f: fake)
    monkeypatch.setenv("PNR_TPU_NO_WARM_ASYNC", "1")
    assert tracker.warm_async(field) is None and not started


class FailingWarmRunner(RecordingRunner):
    """A recording runner with `StageGraphs`' warm thread, whose work
    fails."""

    start_warm = graphs.StageGraphs.start_warm
    _warm_main = graphs.StageGraphs._warm_main
    join_warm = graphs.StageGraphs.join_warm

    def __init__(self, tracker, field):
        super().__init__(tracker, field)
        self.warm_started, self._warm_thread, self._warm_error = False, None, None
        self.warm_s = self.warm_wait_s = 0.0

    def warm(self, ready, slots):
        raise ValueError("no graph for you")


def test_a_failing_warm_thread_raises_from_the_wave():
    """An exception in the warm thread is kept, and the wave loop raises
    it before its first stage: no stage runs, nothing is committed."""
    tracker, field = tracker_and_field("exact", ni=14, trace_chunk=8, stage_iters=4)
    runner = FailingWarmRunner(tracker, field)
    tracker.stage_graphs = lambda f: runner
    runner.start_warm(None, 2).join()
    committer = reconstruct.TraceCommitter((12, 36, 48), CFG.vol, CFG.nodepervol, NodeList(),
                                           None)
    sp, sd = seeds_on_the_axis(4)
    with pytest.raises(RuntimeError, match="warming the tracer's stage graphs failed: no graph"):
        reconstruct._trace_and_commit_wave(tracker, committer, field, sp, sd, np.arange(4),
                                           tf.key_from_seed(1), tracker.cfg, 0)
    assert not runner.log and len(committer.nodes) == 1
    assert isinstance(runner.warm_s, float) and runner._warm_error is None


def test_capture_takes_back_its_launches_and_each_replay_adds_them():
    """A capture counted its graph's launches without making them: they are
    taken back; every replay adds them (and one to REPLAYS); CAPTURES
    counts captures. A stage captured once and replayed three times counts
    three stages' launches."""
    class Counters:
        LAUNCHES, OTHER = 100, 7

    fake = Counters()
    launches = {(fake, "LAUNCHES"): 16}
    caps, reps = graphs.CAPTURES, graphs.REPLAYS
    fake.LAUNCHES += 16  # what the capture pass counted
    graphs._take_back(launches)
    assert fake.LAUNCHES == 100 and graphs.CAPTURES == caps + 1
    for _ in range(3):
        graphs._count_replay(launches)
    assert (fake.LAUNCHES, fake.OTHER) == (148, 7) and graphs.REPLAYS == reps + 3


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_a_stage_tallies_two_launches_an_iteration_on_its_counter(mode):
    """While a thread captures, the tracer tallies each likelihood
    evaluation on its kernel's counter: two an iteration (the particles
    and the centroid), K2's in exact mode and tube_corr's tracer counter
    in tube mode; and the stage's draws, one on the Threefry kernel's.
    Another thread's evaluations are not tallied."""
    tracker, field = tracker_and_field(mode)
    t, n_it = 6, 3
    sp, sd = seeds_on_the_axis(t)
    keys = threefry.key_tensor(trace_keys(tf.key_from_seed(3), np.arange(t)), "cpu")
    carry, _ = tracker.trace_init(field, sp, sd, keys)
    it0 = torch.ones((), dtype=torch.int32)
    kill = torch.zeros(t, dtype=torch.bool)

    other = {}

    def elsewhere():
        tracker._stage_body(field, carry, keys, it0, kill, 1)
        other["tally"] = graphs._TALLY.counts

    graphs._TALLY.counts = tally = {}
    try:
        worker = threading.Thread(target=elsewhere)
        worker.start()
        worker.join(timeout=60)
        tracker._stage_body(field, carry, keys, it0, kill, n_it)
    finally:
        graphs._TALLY.counts = None
    assert not worker.is_alive() and other["tally"] is None
    counter = (tube_corr, "TRACE_LAUNCHES") if mode == "tube" else (zncc_exact, "LAUNCHES")
    assert tally == {counter: 2 * n_it, (threefry, "LAUNCHES"): 1}


def test_graphs_are_asked_for_only_on_a_card():
    """The eager route on the CPU: `stage_graphs` gives no runner for a CPU
    field, whatever the flag."""
    for flag in (True, False):
        tracker, field = tracker_and_field("tube", graphs=flag)
        assert tracker.graphs is flag and tracker.stage_graphs(field) is None


def test_capture_gate_holds_warm_captures_while_closed():
    """`CaptureGate`: `close` waits for the capture in progress and lets no
    new one start until `open`; `cancel` makes a waiting capture raise."""
    gate = graphs.CaptureGate()
    order, inside = [], threading.Event()
    release = threading.Event()

    def capture(name, hold=None):
        try:
            with gate.capture():
                order.append(name)
                if hold is not None:
                    inside.set()
                    hold.wait(timeout=30)
        except RuntimeError as e:
            order.append(f"{name}: {e}")

    first = threading.Thread(target=capture, args=("first", release))
    first.start()
    assert inside.wait(timeout=30)
    closer = threading.Thread(target=gate.close)
    closer.start()
    closer.join(timeout=0.2)
    assert closer.is_alive()  # the capture in progress holds it
    release.set()
    closer.join(timeout=30)
    first.join(timeout=30)
    assert not closer.is_alive() and not first.is_alive()
    second = threading.Thread(target=capture, args=("second",))
    second.start()
    second.join(timeout=0.2)
    assert second.is_alive() and order == ["first"]  # the gate is closed
    gate.open()
    second.join(timeout=30)
    assert not second.is_alive() and order == ["first", "second"]
    gate.close()
    third = threading.Thread(target=capture, args=("third",))
    third.start()
    gate.cancel()
    third.join(timeout=30)
    assert not third.is_alive()
    assert order[-1] == "third: the stage-graph captures were cancelled"
