#!/usr/bin/env python3
"""Two trees of the PyTorch port on one card, in turns, on the paths of
chip_smoke.py's stacks.

    python scripts/torch_trees_ab.py --trees PARENT_DIR,. [--labels parent,change]
                                     [--paths routes,2d,soma] [--modes exact,tube]
                                     [--turns 2] [--runs 3] [--json RUNS.json]

Each tree is a checkout of the repository (a `git archive` of a commit
unpacked into a directory that .gitignore lists). Both trees' kernel and
native libraries are built first, in parallel. Then one process a tree runs
in turns (A, B, B, A for two turns), and in it each of `--paths` through
`reconstruction_func`, one warm-up run first and then `--runs` runs:

* routes: chip_smoke.py's 52.4-Mvox (128, 640, 640) main stack at its CLI
  parameters, in each of `--modes`, on the tracer's three routes: eager
  stages (`BatchedTracker(..., graphs=False)`), stage graphs captured at
  each key's first stage (PNR_TPU_NO_WARM_ASYNC=1) and graphs captured by
  the warm thread (the default);
* 2d: the 2-D main plane (1, 4096, 4096) at zdist 1, in each of `--modes`;
* soma: the main stack with two soma blobs, somaradius 4, exact.

It uses only what both trees offer: no switch is added to either program.
Prints each run's seconds and stage seconds, per tree, path, mode and
route; on the routes path the tracing thread's host milliseconds per stage:
the wave loop's commits (its `tracing.commit` spans, where the tree's
result has them: `ReconstructionResult.spans`) and, where
the tree's runner reports them (`StageGraphs.stats()["host_s"]`), the
staging, replay and fetch; the card's name and power limit; with --json,
every run to that file. Fails unless every run of every tree gives the
same tree and trace count on each path and mode, and on the routes path
the same K2 / `tube_corr` launches. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import sys
import time

from torch_ab_common import build_trees, card, load_smoke, run_child, turn_order

ROUTES = ("eager", "graphs", "warm")
RESULT = "TREES_AB "


def _digest(res) -> str:
    h = hashlib.sha256()
    for nodes in (res.tree, res.n0):
        for f in ("x", "y", "z", "sig", "corr", "type"):
            h.update(repr(list(map(float, getattr(nodes, f)))).encode())
    h.update(str(res.trace_count).encode())
    return h.hexdigest()[:16]


def _routes(torch, smoke, modes, runs):
    """The main stack's three tracer routes in each mode."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.ops import tube_corr, zncc_exact
    from pnr_tpu_torch.pipeline import reconstruction_func
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    vol = smoke.make_volume(smoke.MAIN_SHAPE)
    out = {}
    for mode in modes:
        cfg = dataclasses.replace(PNRConfig.from_cli_params(smoke.MAIN_PARAMS), zncc_mode=mode)
        reconstruction_func(vol, cfg, verbose=False, device="cuda")  # warm-up
        rows = []
        for route in ROUTES:
            for _ in range(runs):
                tracker = BatchedTracker(cfg, "cuda", graphs=route != "eager")
                if route == "graphs":
                    os.environ["PNR_TPU_NO_WARM_ASYNC"] = "1"
                before = (zncc_exact.LAUNCHES, tube_corr.TRACE_LAUNCHES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    res = reconstruction_func(vol, cfg, verbose=False, device="cuda",
                                              _tracker=tracker)
                    torch.cuda.synchronize()
                finally:
                    os.environ.pop("PNR_TPU_NO_WARM_ASYNC", None)
                wall = time.perf_counter() - t0
                log = tracker.graph_log[-1] if tracker.graph_log else {}
                # the stages the tracing thread dispatched (eager: none logged)
                stages = sum(log.get("routes", {}).values())
                commits = getattr(res, "spans", {}).get("tracing.commit", (0.0, 0))[0]
                host = {"commits": commits, **log.get("host_s", {})}
                rows.append({
                    "route": route, "s": wall, "stages_s": res.timings,
                    "digest": _digest(res), "traces": res.trace_count,
                    "k2": zncc_exact.LAUNCHES - before[0],
                    "tube_corr": tube_corr.TRACE_LAUNCHES - before[1],
                    "warm_inits": log.get("warm_inits", 0), "stages": stages,
                    "host_ms_per_stage": {k: 1e3 * v / stages for k, v in host.items()}
                    if stages else None})
                del tracker, res
        out[mode] = rows
    return out


def _plain_runs(torch, smoke, vol, cfg, runs):
    """One warm-up run and `runs` runs of `reconstruction_func` on the
    tracer's default route."""
    from pnr_tpu_torch.pipeline import reconstruction_func

    reconstruction_func(vol, cfg, verbose=False, device="cuda")
    rows = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = reconstruction_func(vol, cfg, verbose=False, device="cuda")
        torch.cuda.synchronize()
        rows.append({"route": "warm", "s": time.perf_counter() - t0, "stages_s": res.timings,
                     "digest": _digest(res), "traces": res.trace_count})
        del res
    return rows


def child(tree: str, paths, modes, runs: int) -> int:
    """One tree's runs, in this process; prints one RESULT line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from pnr_tpu_torch import PNRConfig

    smoke = load_smoke()
    out = {}
    if "routes" in paths:
        out["routes"] = _routes(torch, smoke, modes, runs)
    if "2d" in paths:
        vol = smoke.make_volume(smoke.PLANE_SHAPE)
        out["2d"] = {mode: _plain_runs(torch, smoke, vol, dataclasses.replace(
            PNRConfig.from_cli_params(smoke.PLANE_PARAMS), zncc_mode=mode), runs)
            for mode in modes}
    if "soma" in paths:
        vol = smoke.make_soma_volume(smoke.MAIN_SHAPE)
        cfg = dataclasses.replace(PNRConfig.from_cli_params(smoke.SOMA_PARAMS), zncc_mode="exact")
        out["soma"] = {"exact": _plain_runs(torch, smoke, vol, cfg, runs)}
    print(RESULT + json.dumps(out), flush=True)
    return 0


def _r4(xs):
    return [round(x, 4) for x in xs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", help="two tree directories, comma-separated")
    ap.add_argument("--labels", default="parent,change")
    ap.add_argument("--paths", default="routes,2d,soma")
    ap.add_argument("--modes", default="exact,tube")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--json", help="write every run to this JSON file")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    paths, modes = args.paths.split(","), args.modes.split(",")
    if args.child:
        return child(args.child, paths, modes, args.runs)
    if not args.trees:
        ap.error("--trees is required")

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    labels = args.labels.split(",")
    gpu = card()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    if not build_trees(trees):
        print("a tree's libraries did not build", file=sys.stderr)
        return 1
    print(f"[trees ab] built the trees' libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    order = turn_order(len(trees), args.turns)
    results = {label: [] for label in labels}
    for i in order:
        got = run_child(__file__, trees[i], ["--paths", args.paths, "--modes", args.modes,
                                             "--runs", str(args.runs)], RESULT)
        if got is None:
            return 1
        results[labels[i]].append(got)
        for path, by_mode in got.items():
            for mode, rows in by_mode.items():
                for route in dict.fromkeys(r["route"] for r in rows):
                    rs = [r for r in rows if r["route"] == route]
                    host = [r["host_ms_per_stage"] for r in rs if r.get("host_ms_per_stage")]
                    print(f"[trees ab {path} {mode}] {labels[i]} {route}: run "
                          f"{_r4(r['s'] for r in rs)} s; stages " + json.dumps(
                              [{k: round(v, 4) for k, v in r["stages_s"].items()} for r in rs])
                          + ("; host ms per stage " + json.dumps(
                              [{k: round(v, 4) for k, v in h.items()} for h in host])
                             if host else "") + f" [{gpu}]", flush=True)
    ok = True
    for path in paths:
        for mode in results[labels[0]][0][path]:
            rows = [r for label in labels for got in results[label] for r in got[path][mode]]
            same = {(r["digest"], r["traces"]) for r in rows}
            ok &= len(same) == 1
            msg = f"[trees ab {path} {mode}] trees and trace counts {sorted(same)}"
            if path == "routes":
                tracer = "k2" if mode == "exact" else "tube_corr"
                counts = {r[tracer] - 2 * r["warm_inits"] for r in rows}
                ok &= len(counts) == 1
                msg += f"; the tracer's launches less the warm thread's {sorted(counts)}"
            print(f"{msg} over {len(rows)} runs", flush=True)
            for route in dict.fromkeys(r["route"] for r in rows):
                for label in labels:
                    got = [r for g in results[label] for r in g[path][mode] if r["route"] == route]
                    run_s = [r["s"] for r in got]
                    print(f"[trees ab {path} {mode}] {route} {label}: run (in turns) "
                          f"{_r4(run_s)}, median {statistics.median(run_s):.4f}; tracing "
                          f"{_r4(r['stages_s']['tracing'] for r in got)} [{gpu}]", flush=True)
    if args.json:
        doc = {"card": gpu, "labels": labels, "trees": trees,
               "order": [labels[i] for i in order], "results": results}
        with open(args.json, "w") as f:
            json.dump(doc, f)
        print(f"[trees ab] every run: {args.json}", flush=True)
    if not ok:
        print("[trees ab] the trees' runs differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
