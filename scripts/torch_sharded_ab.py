#!/usr/bin/env python3
"""Two trees of the PyTorch port on one card, in turns, on the mesh
tracers' paths: the sharded pipeline on a virtual mesh of four shards and
batch DP on a virtual mesh of one shard a stack.

    python scripts/torch_sharded_ab.py --trees PARENT_DIR,. [--labels parent,change]
                                       [--paths sharded,batch_dp] [--modes exact,tube]
                                       [--turns 2] [--runs 2] [--json RUNS.json]

Each tree is a checkout of the repository (a `git archive` of a commit
unpacked into a directory that .gitignore lists). Both trees' kernel and
native libraries are built first, in parallel. Then one process a tree runs
in turns (A, B, B, A for two turns), and in it, in each of `--modes`, one
warm-up run and then `--runs` runs of each of `--paths`, on chip_smoke.py's
52.4-Mvox (128, 640, 640) stacks (`make_volume`, seeds 0-3) at its CLI
parameters:

* sharded: `reconstruction_func_sharded` of stack 0 over
  `Mesh((cuda:0,) * 4)`;
* batch_dp: `reconstruction_batch_dp` of the four stacks over
  `Mesh((cuda:0,) * 4)`, and beside it `reconstruction_batch` of the same
  stacks with `fused_frangi=False` and prefetch (the single-stack route
  of the same work).

In each tree's first turn one more run of each path goes under the
profiler (chip_smoke.py's `phase_profile`): the host's launch calls a
tracer step. Both trees run this checkout's chip_smoke.py against their
own package; no switch is added to either program. Prints each run's
seconds and its tracing stage's, per tree, path and mode, then per path,
mode and tree the median and the range over every run, whether every run
of a tree gave one tree and trace count (and whether the two trees gave
the same), and the card's name and power limit; with --json, every run to
that file. Fails unless every run of a tree gives the same trees and trace
counts on each path and mode. It needs a CUDA device.
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

from torch_ab_common import build_trees, card, load_smoke, run_child, spread, turn_order

RESULT = "SHARDED_AB "
TRACING = {"sharded": "tracing (sharded, staged handoff)",
           "batch_dp": "tracing (batch, lockstep waves)"}


def _digest(results) -> str:
    h = hashlib.sha256()
    for res in results:
        for nodes in (res.tree, res.n0):
            for f in ("x", "y", "z", "sig", "corr", "type"):
                h.update(repr(list(map(float, getattr(nodes, f)))).encode())
        h.update(str(res.trace_count).encode())
    return h.hexdigest()[:16]


def child(tree: str, paths, modes, runs: int, profile: bool) -> int:
    """One tree's runs, in this process; prints one RESULT line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.parallel import Mesh, reconstruction_batch_dp
    from pnr_tpu_torch.pipeline import reconstruction_batch, reconstruction_func_sharded

    smoke = load_smoke()
    vols = [smoke.make_volume(smoke.MAIN_SHAPE, seed=i) for i in range(4)]
    mesh = Mesh((torch.device("cuda", 0),) * 4)
    gpu = card()
    out = {}
    for path in paths:
        out[path] = {}
        for mode in modes:
            cfg = dataclasses.replace(PNRConfig.from_cli_params(smoke.MAIN_PARAMS),
                                      zncc_mode=mode, fused_frangi=False)
            if path == "sharded":
                def run(cfg=cfg):
                    return [reconstruction_func_sharded(vols[0], cfg, mesh, verbose=False)]
            else:
                def run(cfg=cfg):
                    return reconstruction_batch_dp(vols, cfg, mesh)
            run()  # warm-up
            rows = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                rows.append({"s": time.perf_counter() - t0,
                             "tracing_s": [r.timings[TRACING[path]] for r in res],
                             "digest": _digest(res), "traces": [r.trace_count for r in res]})
                del res
            entry = {"runs": rows}
            if path == "batch_dp":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                list(reconstruction_batch(vols, cfg, prefetch=True, device="cuda"))
                torch.cuda.synchronize()
                entry["batch_prefetch_s"] = time.perf_counter() - t0
            if profile:
                prof = smoke.phase_profile(
                    torch, gpu, mode, run, statistics.median(r["s"] for r in rows),
                    label=f"sharded ab {path} {mode}",
                    want=("K4", "tube_corr (K5, K6)" if mode == "tube" else "K2"))
                entry["host_calls_per_step"] = prof["host_calls_per_step"]
                entry["busy_ms"] = prof["busy_ms"]
            out[path][mode] = entry
    print(RESULT + json.dumps(out), flush=True)
    return 0


def _r4(xs):
    return [round(x, 4) for x in xs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", help="two tree directories, comma-separated")
    ap.add_argument("--labels", default="parent,change")
    ap.add_argument("--paths", default="sharded,batch_dp")
    ap.add_argument("--modes", default="exact,tube")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--json", help="write every run to this JSON file")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    paths, modes = args.paths.split(","), args.modes.split(",")
    if args.child:
        return child(args.child, paths, modes, args.runs, args.profile)
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
    print(f"[sharded ab] built the trees' libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    order = turn_order(len(trees), args.turns)
    results = {label: [] for label in labels}
    for i in order:
        first = not results[labels[i]]
        got = run_child(__file__, trees[i], ["--paths", args.paths, "--modes", args.modes,
                                             "--runs", str(args.runs)]
                        + (["--profile"] if first else []), RESULT)
        if got is None:
            return 1
        results[labels[i]].append(got)
        for path, by_mode in got.items():
            for mode, entry in by_mode.items():
                rows = entry["runs"]
                extra = "".join(f"; {k} {round(entry[k], 4)}" for k in
                                ("batch_prefetch_s", "host_calls_per_step", "busy_ms")
                                if k in entry)
                print(f"[sharded ab {path} {mode}] {labels[i]}: run {_r4(r['s'] for r in rows)} s, "
                      f"tracing (stack 1) {_r4(r['tracing_s'][0] for r in rows)} s{extra} "
                      f"[{gpu}]", flush=True)
    ok = True
    for path in paths:
        for mode in modes:
            digests = {}
            for label in labels:
                entries = [g[path][mode] for g in results[label]]
                rows = [r for e in entries for r in e["runs"]]
                digests[label] = {(r["digest"], tuple(r["traces"])) for r in rows}
                ok &= len(digests[label]) == 1
                n = len(rows[0]["traces"])
                run_s = [r["s"] for r in rows]
                line = (f"[sharded ab {path} {mode}] {label}: run (in turns) {_r4(run_s)}, "
                        f"{spread(run_s)}; a stack {spread([x / n for x in run_s])}; tracing "
                        f"(stack 1) {spread([r['tracing_s'][0] for r in rows])}")
                prefetch = [e["batch_prefetch_s"] / n for e in entries if "batch_prefetch_s" in e]
                if prefetch:
                    line += f"; reconstruction_batch prefetched, a stack {spread(prefetch)}"
                calls = [e["host_calls_per_step"] for e in entries if "host_calls_per_step" in e]
                if calls:
                    line += f"; host launch calls a tracer step {round(calls[0], 1)}"
                print(line + f"; one tree and trace count {len(digests[label]) == 1} [{gpu}]",
                      flush=True)
            print(f"[sharded ab {path} {mode}] the trees give the same trees and trace counts: "
                  f"{len({d for ds in digests.values() for d in ds}) == 1}", flush=True)
    if args.json:
        doc = {"card": gpu, "labels": labels, "trees": trees,
               "order": [labels[i] for i in order], "results": results}
        with open(args.json, "w") as f:
            json.dump(doc, f)
        print(f"[sharded ab] every run: {args.json}", flush=True)
    if not ok:
        print("[sharded ab] a tree's runs differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
