"""A run on the CPU with the timed path broken underneath: `correct` is false.

Each test drives `run_cell` past the harness's look for a chip, on small
stacks and short traces, with one fault planted in the program: a tracer
stage that returns its state unchanged; seed scoring that scores half the
seeds and gives the rest their mean; J8 altered where the filter makes
it; the tree altered where the graph stage makes it. The exchange between
chips is absent from these one-chip cells. A sound run of the same size
comes out correct.
"""

import torch

from benchmark import run
from benchmark.core import check
from benchmark.tests._small import CONFIG, SEED, TRAFFIC


def _run(workload="exact-arbors-single", trace=False):
    traffic = dict(TRAFFIC)
    if "batch" in workload:
        traffic["warmup_stacks"] = 2
    return run.run_cell(workload, SEED, 0.5, trace, device="cpu", traffic_override=traffic,
                        config_override=CONFIG, check_stacks=1, log=lambda *a, **k: None)


def _failed(out):
    return [k for k, c in out["checks"].items() if c["limit"] is not None and c["value"] > c["limit"]]


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and set(out["metrics"]) == {"stacks_per_s", "swc_f1", "setup_s"}
    assert list(out["checks"]) == list(check.ALL)


def test_traced_run_reads_the_per_layer_metrics():
    # no card: no profiler, so the readers of the trace find nothing
    out = _run("exact-arbors-batch", trace=True)
    assert out["correct"]
    assert {"frangi_ms", "seeds_ms", "tracing_ms", "graph_ms", "front_overlap"} <= set(out["metrics"])
    assert not {"k1_roofline", "device_idle_share"} & set(out["metrics"])


def test_stage_returning_its_state_unchanged(monkeypatch):
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    real = BatchedTracker._stage_iters

    def frozen(self, field, carry, u1, ru, kill, n_it, frame=None):
        _, packed = real(self, field, carry, u1, ru, kill, n_it, frame)
        return carry, packed[:, :1].expand(-1, n_it, -1).clone()

    monkeypatch.setattr(BatchedTracker, "_stage_iters", frozen)
    out = _run()
    assert not out["correct"] and "node_step_off" in _failed(out)


def test_half_the_seeds_scored_the_rest_given_their_mean(monkeypatch):
    import numpy as np

    from pnr_tpu_torch.pipeline import reconstruct

    real = reconstruct._score_seeds

    def half(field, pos, dirs, tracker):
        n = len(pos) // 2
        c = real(field, pos[:n], dirs[:n], tracker) if n else np.zeros(0, np.float32)
        rest = np.full(len(pos) - n, c.mean() if n else 0.0, np.float32)
        return np.concatenate([c, rest]).astype(np.float32)

    monkeypatch.setattr(reconstruct, "_score_seeds", half)
    out = _run()
    assert not out["correct"] and {"seed_set_off", "seed_corr_gap"} & set(_failed(out))


def test_j8_altered_where_it_is_made(monkeypatch):
    from pnr_tpu_torch.pipeline import reconstruct

    real = reconstruct.normalize_to_u8

    def altered(j, jmin, jmax):
        j8 = real(j, jmin, jmax)
        j8[::4] = torch.clamp(j8[::4].to(torch.int32) + 2, 0, 255).to(torch.uint8)
        return j8

    monkeypatch.setattr(reconstruct, "normalize_to_u8", altered)
    out = _run("exact-arbors-batch")
    assert not out["correct"] and "j8_off" in _failed(out)


def test_tree_altered_where_it_is_made(monkeypatch):
    from pnr_tpu_torch.pipeline import reconstruct

    real = reconstruct.reconstruct_graph

    def altered(n0, cfg, device, midres=None):
        tree = real(n0, cfg, device, midres)
        for i in range(1, len(tree), 3):
            tree.x[i] += 1.0
        return tree

    monkeypatch.setattr(reconstruct, "reconstruct_graph", altered)
    out = _run()
    assert not out["correct"] and "tree_off" in _failed(out)
