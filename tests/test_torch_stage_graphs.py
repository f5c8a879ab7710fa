"""The single-stack tracer's stage split and the host side of its stage-graph
runner (pnr_tpu_torch/smc/graphs.py), on the CPU: `_stage_body` fed
`stage_uniforms` is bitwise `trace_stage` (itself held to the JAX tracer
in tests/test_torch_tracker.py); `StagePlan`'s routes over the main
stack's two waves; the wave loop through a runner's protocol (`load`,
`stage`, `finish`) is bitwise the eager wave; the launch bookkeeping of
captures and replays. The graphs themselves need a card:
tests/test_torch_kernels.py (`-k graphs`)."""

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
    retires every third trace: `_stage_body` on the uniforms of
    `stage_uniforms` gives `trace_stage`'s carry and packed estimates bit
    for bit (n_it None: the tracker's STAGE_ITERS)."""
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
                u1, ru = (torch.from_numpy(a) for a in tracker.stage_uniforms(keys, it0, n_it))
                carry, packed = tracker._stage_body(field, carry, u1, ru, kill, n_it)
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
    wave of n_traces traces that runs to its last iteration, in order."""
    slots = [min(chunk, n_traces - b) for b in range(0, n_traces, chunk)]
    return [(c, t, min(stage, ni - it0)) for it0 in range(1, ni, stage)
            for c, t in enumerate(slots)]


@pytest.mark.parametrize("mode,stage", [("exact", 8), ("tube", 16)])
def test_plan_over_the_main_stacks_two_waves(mode, stage):
    """The main stack at ni 100 (`-p 2,4,6 0 10 0.5 3 2 100 20 2 4 9`):
    a wave of 256 traces (two slots of T=128), then one of 90 (slot 0 at
    T=90). Per key the first stage runs eagerly, the second is captured,
    the rest replay; the last, shorter stage of each slot (n_it 3) runs
    once, eagerly."""
    plan = graphs.StagePlan()
    routes = {}
    for n in (256, 90):
        for key in main_stack_wave_keys(n, 100, stage):
            routes.setdefault(key, []).append(plan.route(key))
    full = 99 // stage
    assert 99 % stage == 3
    full_routes = [graphs.EAGER, graphs.CAPTURE] + [graphs.REPLAY] * (full - 2)
    assert routes == {(0, 128, stage): full_routes, (1, 128, stage): full_routes,
                      (0, 128, 3): [graphs.EAGER], (1, 128, 3): [graphs.EAGER],
                      (0, 90, stage): full_routes, (0, 90, 3): [graphs.EAGER]}


class RecordingRunner:
    """The runner's protocol on the CPU: each stage runs `trace_stage`
    eagerly on the loaded carry, and its key's route is recorded."""

    def __init__(self, tracker, field):
        self.tracker, self.field = tracker, field
        self.plan = graphs.StagePlan()
        self.carries, self.log, self.finished = {}, [], 0

    def load(self, slot, carry):
        self.carries[slot] = carry

    def stage(self, slot, keys, it0, n_it, kill):
        key = (slot, len(kill), n_it)
        self.log.append((key, self.plan.route(key)))
        self.carries[slot], packed = self.tracker.trace_stage(
            self.field, keys, self.carries[slot], it0, n_it, torch.from_numpy(kill.copy()))
        return types.SimpleNamespace(numpy=packed.numpy)

    def finish(self):
        self.finished += 1


@pytest.mark.parametrize("mode", ["exact", "tube"])
def test_wave_loop_through_a_runner_is_bitwise_eager(mode):
    """`_trace_and_commit_wave` through a runner (two waves: 16 traces in
    two slots of 8, then 10 in slots of 8 and 2) commits bitwise what the
    eager wave commits; every key's routes follow the plan, and the wave
    ends by calling `finish`."""
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
    assert runner.finished == 2
    by_key = {}
    for key, route in runner.log:
        by_key.setdefault(key, []).append(route)
    assert {t for _, t, _ in by_key} == {8, 2}
    for key, got in by_key.items():
        want = [graphs.EAGER, graphs.CAPTURE] + [graphs.REPLAY] * (len(got) - 2)
        assert got == want[:len(got)], key
    assert any(graphs.REPLAY in got for got in by_key.values())


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
    in tube mode. Another thread's evaluations are not tallied."""
    tracker, field = tracker_and_field(mode)
    t, n_it = 6, 3
    sp, sd = seeds_on_the_axis(t)
    keys = trace_keys(tf.key_from_seed(3), np.arange(t))
    carry, _ = tracker.trace_init(field, sp, sd, keys)
    u1, ru = (torch.from_numpy(a) for a in tracker.stage_uniforms(keys, 1, n_it))
    kill = torch.zeros(t, dtype=torch.bool)

    other = {}

    def elsewhere():
        tracker._stage_body(field, carry, u1, ru, kill, 1)
        other["tally"] = graphs._TALLY.counts

    graphs._TALLY.counts = tally = {}
    try:
        worker = threading.Thread(target=elsewhere)
        worker.start()
        worker.join(timeout=60)
        tracker._stage_body(field, carry, u1, ru, kill, n_it)
    finally:
        graphs._TALLY.counts = None
    assert not worker.is_alive() and other["tally"] is None
    counter = (tube_corr, "TRACE_LAUNCHES") if mode == "tube" else (zncc_exact, "LAUNCHES")
    assert tally == {counter: 2 * n_it}


def test_graphs_are_asked_for_only_on_a_card():
    """The eager route on the CPU: `stage_graphs` gives no runner for a CPU
    field, whatever the flag."""
    for flag in (True, False):
        tracker, field = tracker_and_field("tube", graphs=flag)
        assert tracker.graphs is flag and tracker.stage_graphs(field) is None
