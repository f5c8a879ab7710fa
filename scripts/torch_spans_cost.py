#!/usr/bin/env python3
"""The port's part spans (pnr_tpu_torch/utils/spans.py) on one card: what
they cost, and what a torch profiler session sees of them.

    python scripts/torch_spans_cost.py [--stacks 2] [--spans 200000] [--seed 7]

1. A span's cost: `--spans` empty spans on a bound stack, with no
   profiler session and under one (CPU and CUDA activities, started as the
   benchmark's traced run starts it), in microseconds a span.
2. Stacks of the benchmark's traffic (`benchmark/traffic/arbors-single.json`,
   (128, 640, 640), at `benchmark/configs/advantra-readme-exact.json`),
   after one warm-up: `--stacks` through `reconstruction_func` with no
   session (each stack's seconds, its spans and their count); `--stacks`
   more under a session started as the benchmark starts it; a prefetched
   `reconstruction_batch` of `--stacks` + 1 under a session that records
   every thread (`profile_all_threads`). For each session: the span names
   seen as host events against the stacks' own counts, those missed, and
   every device event that carries a span's or a stage's name. A
   `record_function` range around one kernel launch is the control: its
   device-side annotation must be seen.

Prints the card's name and power limit, a line a part and one JSON line.
It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from torch_ab_common import ROOT, card as card_line

sys.path.insert(0, ROOT)

STAGES = ("frangi", "seed extraction", "seed selection & sorting", "tracing", "reconstruct")


def span_cost(torch, spans, n: int, session) -> float:
    """Microseconds a span: `n` empty spans on a bound stack, inside
    `session` (a context manager)."""
    stack = spans.Spans()
    with session, spans.bound(stack):
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("tracing.wait"):
                pass
        dt = time.perf_counter() - t0
    assert len(stack.records) == n
    return 1e6 * dt / n


def session(torch, all_threads: bool):
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw)


def seen(prof, spans, results, control: bool):
    """What one session shows of the stacks' spans."""
    from torch.autograd import DeviceType

    names = set(spans.NAMES) | set(STAGES) | {"control range"}
    host, dev = {}, {}
    for e in prof.profiler.kineto_results.events():
        n = e.name()
        if n not in names:
            continue
        side = host if e.device_type() == DeviceType.CPU else dev
        side[n] = side.get(n, 0) + 1
    want = {}
    for r in results:
        for k, (_, c) in r.spans.items():
            want[k] = want.get(k, 0) + c
    return {"host": host, "device": dev, "want": want,
            "missed": sorted(k for k in want if host.get(k, 0) < want[k]),
            "control_on_device": dev.get("control range", 0) if control else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stacks", type=int, default=2)
    ap.add_argument("--spans", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import contextlib

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    from benchmark.run import load_cell, make_cfg
    from benchmark.traffic import arbors
    from pnr_tpu_torch.pipeline import reconstruction_batch, reconstruction_func
    from pnr_tpu_torch.utils import spans

    card = card_line()
    out = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "range_kind": getattr(spans._RANGE, "__name__", None)}
    print(f"[spans] torch {torch.__version__}, CUDA {torch.version.cuda}, range "
          f"{out['range_kind']} [{card}]", flush=True)

    # 1. a span's cost
    span_cost(torch, spans, 1000, contextlib.nullcontext())
    off = span_cost(torch, spans, args.spans, contextlib.nullcontext())
    on = span_cost(torch, spans, args.spans, session(torch, False))
    out["span_us"] = {"profiler_off": off, "profiler_on": on}
    print(f"[spans] a span costs {off:.3f} us with no profiler session, {on:.3f} us under one "
          f"[{card}]", flush=True)

    # 2. the benchmark's stacks
    _, _, config, traffic = load_cell("exact-arbors-single")
    cfg = make_cfg(config)
    n = args.stacks
    vols = [arbors.make_stack(traffic["stack"], args.seed, i, cfg.zdist, "cuda")[0].cpu().numpy()
            for i in range(3 * n + 2)]
    reconstruction_func(vols[0], cfg, verbose=False, device="cuda")
    rows = []
    for v in vols[1:n + 1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = reconstruction_func(v, cfg, verbose=False, device="cuda")
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        count = sum(c for _, c in r.spans.values())
        rows.append({"s": s, "spans": count, "timings": r.timings,
                     "span_s": {k: v for k, (v, _) in r.spans.items()},
                     "span_n": {k: c for k, (_, c) in r.spans.items()}})
        print(f"[spans] stack {len(rows)}: {s:.3f} s, {count} spans, "
              f"{100 * count * off * 1e-6 / s:.4f}% of it at the profiler-off cost "
              f"({count * off * 1e-3:.3f} ms); counts {json.dumps(rows[-1]['span_n'])} [{card}]",
              flush=True)
    out["stacks"] = rows

    # the benchmark's session (the starting thread) and one of every thread
    x = torch.ones(64, device="cuda")
    for label, all_threads, batch in (("benchmark session", False, False),
                                      ("all-threads session", True, True)):
        prof = session(torch, all_threads)
        prof.start()
        for _ in range(32):  # the profiler drops a session's first device events
            x = x * 1.0
        torch.cuda.synchronize()
        with torch.autograd.profiler.record_function("control range"):
            x = x * 1.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if batch:
            got = list(reconstruction_batch(iter(vols[n + 1:2 * n + 2]), cfg, verbose=False,
                                            prefetch=True, prefetch_depth=2, device="cuda"))
        else:
            got = [reconstruction_func(v, cfg, verbose=False, device="cuda")
                   for v in vols[2 * n + 2:3 * n + 2]]
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        prof.stop()
        t1 = time.perf_counter()
        res = seen(prof, spans, got, control=True)
        res.update(s=s, stacks=len(got), read_s=time.perf_counter() - t1)
        out[label] = res
        named = {k: v for k, v in res["device"].items() if k != "control range"}
        print(f"[spans] {label}: {len(got)} stacks in {s:.3f} s; host events of spans "
              f"{json.dumps(res['host'])}; missed {res['missed']}; device events carrying a "
              f"span's or a stage's name {json.dumps(named)}; the record_function control on "
              f"the device {res['control_on_device']} [{card}]", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
