#!/usr/bin/env python3
"""The stage-graph warm thread of the PyTorch port in a batch, on one card.

    python scripts/torch_warm_ab.py [--modes exact,tube] [--stacks 4] [--turns 2]

Runs `reconstruction_batch` on `--stacks` stacks of chip_smoke.py's
52.4-Mvox (128, 640, 640) recipe (`make_volume(MAIN_SHAPE, seed=i)`) with
its CLI parameters, in each mode, on four routes, in turns (the order
reversed every other turn): the tracer's stage graphs captured by each
front's warm thread (`BatchedTracker.warm_async`, the default) or at
each key's first stage on the tracing thread (PNR_TPU_NO_WARM_ASYNC=1),
each with prefetch on and off. Prints one line per batch (its seconds,
each stack's seconds from the previous result, and each stack's runner:
captures on the tracing thread, the warm thread's seconds and the
tracing thread's wait for it), the card's name and power limit, and one
JSON line with every batch. Every batch's trees must be bitwise the
first batch's of its mode. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from torch_ab_common import ROOT, card as card_line, load_smoke, turn_order

sys.path.insert(0, ROOT)

#: (warm thread, prefetch) of each route
ROUTES = {"warm": (True, True), "no_warm": (False, True),
          "warm_one_by_one": (True, False), "no_warm_one_by_one": (False, False)}


def run(torch, smoke, vols, cfg, route):
    """One batch on `route`: (seconds, per-stack seconds, results, runner stats)."""
    from pnr_tpu_torch.pipeline import reconstruct

    made = []
    real = reconstruct.BatchedTracker
    warm, prefetch = ROUTES[route]

    def keep(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    env = {} if warm else {"PNR_TPU_NO_WARM_ASYNC": "1"}
    os.environ.update(env)
    reconstruct.BatchedTracker = keep
    torch.cuda.synchronize()
    secs, results = [], []
    t0 = t_start = time.perf_counter()
    try:
        for res in reconstruct.reconstruction_batch(vols, cfg, prefetch=prefetch, device="cuda"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            secs.append(t1 - t0)
            results.append(res)
            t0 = t1
    finally:
        reconstruct.BatchedTracker = real
        for k in env:
            os.environ.pop(k, None)
    total = time.perf_counter() - t_start
    logs = [log for t in made for log in t.graph_log]
    return total, secs, results, logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="exact,tube")
    ap.add_argument("--stacks", type=int, default=4)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from pnr_tpu_torch import PNRConfig, native

    smoke = load_smoke()
    card = card_line()
    print(card, flush=True)
    if not native.have_native():  # builds the native host library, or says it could not
        print("the native host library did not build", file=sys.stderr)
        return 1
    vols = [smoke.make_volume(smoke.MAIN_SHAPE, seed=i) for i in range(args.stacks)]
    out = {}
    for mode in args.modes.split(","):
        cfg = dataclasses.replace(PNRConfig.from_cli_params(smoke.MAIN_PARAMS), zncc_mode=mode)
        run(torch, smoke, vols[:1], cfg, "warm")  # warm-up: the kernels' first launches
        ref = None
        rows = []
        for r in turn_order(len(ROUTES), args.turns):
            route = list(ROUTES)[r]
            total, secs, results, logs = run(torch, smoke, vols, cfg, route)
            if ref is None:
                ref = results
            same = all(smoke.same_tree(a, b) for a, b in zip(results, ref))
            row = {"route": route, "s": total, "per_stack_s": secs, "bitwise": same,
                   "captures_on_tracing_thread": [lg["routes"]["capture"] for lg in logs],
                   "warm_s": [lg["warm_s"] for lg in logs],
                   "warm_wait_s": [lg["warm_wait_s"] for lg in logs]}
            rows.append(row)
            print(f"[warm ab {mode}] {route}: {total:.4f} s for {len(vols)} stacks, per stack "
                  f"{[round(x, 4) for x in secs]}; captures on the tracing thread "
                  f"{row['captures_on_tracing_thread']}, warm s "
                  f"{[round(x, 4) for x in row['warm_s']]}, waited "
                  f"{[round(x, 4) for x in row['warm_wait_s']]}; bitwise {same} [{card}]",
                  flush=True)
            if not same:
                print(f"[warm ab {mode}] {route}: trees differ from the first batch's",
                      file=sys.stderr)
                return 1
        out[mode] = rows
        for route in ROUTES:
            got = [r["s"] / len(vols) for r in rows if r["route"] == route]
            print(f"[warm ab {mode}] {route}: seconds per stack {[round(x, 4) for x in got]} "
                  f"[{card}]", flush=True)
    print(json.dumps({"card": card, "stacks": len(vols), "batches": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
