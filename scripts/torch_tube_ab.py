#!/usr/bin/env python3
"""The PyTorch port's tube, exact or unfused path on one card, for
comparing two checkouts.

    python scripts/torch_tube_ab.py [--root DIR] [--mode tube|exact|unfused] [--runs N] [--no-profile]

Runs `pnr_tpu_torch` from the checkout at DIR (this one by default) on
chip_smoke.py's 52.4-Mvox (128, 640, 640) stack with its CLI parameters
and `--zncc-mode MODE` (tube by default; unfused: the exact engine with
`fused_frangi=False` through `reconstruction_func`, as the unfused
filter is API-only): N times (2 by default) without
a profiler (the runs after the first are the warm ones), then, unless
--no-profile, once under torch.profiler. Prints one JSON line: the
warm runs' seconds, tracing and frangi stages (and the medians), and for the
profiled run the tracer steps (one iteration of one chunk: two tracer
launches of `tube_corr` or K2, from the launch counters, so that stages
replayed as CUDA graphs count too), the host's launch calls (kernel and
graph launches) in all and per step, the card's busy time and idle share, and the device time of
the likelihood's kernels (tube: named hat_* or tube_corr_*; exact: K2's
exact_sums_*). It needs a CUDA
device and takes the stack, the parameters and the device from
chip_smoke.py, which it loads from this checkout, so two checkouts run
the same work. To compare a parent commit with a change on one card, run
them in turns (parent, change, change, parent) in one session.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

from torch_ab_common import ROOT, load_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose pnr_tpu_torch runs")
    ap.add_argument("--mode", default="tube", choices=("tube", "exact", "unfused"),
                    help="--zncc-mode, or unfused (exact with fused_frangi=False)")
    ap.add_argument("--runs", type=int, default=2, help="unprofiled runs (the first is cold)")
    ap.add_argument("--no-profile", action="store_true", help="skip the profiled run")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("torch_tube_ab: no CUDA device", file=sys.stderr)
        return 1
    cs = load_smoke()
    sys.path.insert(0, root)
    from pnr_tpu_torch import cli
    from pnr_tpu_torch.ops import tube_corr, zncc_exact
    from pnr_tpu_torch.pipeline import reconstruct
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not cli.__file__.startswith(root):
        raise RuntimeError(f"pnr_tpu_torch came from {cli.__file__}, not from {root}")
    # K2's launches in seed scoring, to leave out of the tracer's
    scoring = [0]
    score = reconstruct._score_seeds

    def counted(*a, **k):
        n = zncc_exact.LAUNCHES
        try:
            return score(*a, **k)
        finally:
            scoring[0] += zncc_exact.LAUNCHES - n

    reconstruct._score_seeds = counted

    def tracer_launches():
        if args.mode == "tube":
            return tube_corr.TRACE_LAUNCHES
        return zncc_exact.LAUNCHES - scoring[0]

    workdir = tempfile.mkdtemp(prefix=".tube_ab_", dir=root)
    try:
        src = os.path.join(workdir, "stack.npy")
        vol = cs.make_volume(cs.MAIN_SHAPE)
        np.save(src, vol)
        timings = {}

        def run(tag):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if args.mode == "unfused":
                from pnr_tpu_torch import PNRConfig
                from pnr_tpu_torch.pipeline import reconstruction_func

                cfg = dataclasses.replace(PNRConfig.from_cli_params(cs.MAIN_PARAMS),
                                          fused_frangi=False)
                timings[tag] = reconstruction_func(vol, cfg, verbose=False,
                                                   device=cs.DEVICE).timings
            else:
                rc = cli.main(cs.cli_argv(src, workdir, tag, args.mode))
                if rc != 0:
                    raise RuntimeError(f"the {args.mode} CLI run {tag} exited {rc}")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if args.mode != "unfused":
                with open(os.path.join(workdir, f"{tag}.json")) as f:
                    timings[tag] = json.load(f)["stacks"][0]["timings_s"]
            return dt

        warm_s, stages = [], []
        for i in range(1, max(args.runs, 2) + 1):
            t = run(f"{args.mode}{i}")
            if i > 1:
                warm_s.append(t)
                stages.append(timings[f"{args.mode}{i}"])
        tracing = [st.get("tracing") for st in stages]
        frangi = [st.get("frangi") for st in stages]
        row = {"root": root, "mode": args.mode, "card": torch.cuda.get_device_name(0),
               "run2_s": warm_s[0], "tracing_s": tracing[0], "stages_s": stages[0],
               "warm_s": warm_s, "warm_tracing_s": tracing,
               "warm_frangi_s": frangi,
               "median_s": statistics.median(warm_s),
               "median_tracing_s": statistics.median(tracing),
               "median_frangi_s": statistics.median(frangi)}
        if args.no_profile:
            print(json.dumps(row), flush=True)
            return 0
        before = tracer_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_s = run(f"{args.mode}p")
        steps = (tracer_launches() - before) // 2
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("Activity Buffer")]
    busy_us, end = 0.0, -1.0
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    names = ("hat_", "tube_corr") if args.mode == "tube" else ("exact_sums",)
    lik = [e for e in dev if e.name.startswith(names) or any(f"::{n}" in e.name for n in names)]
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")))
    print(json.dumps({
        **row, "profiled_s": profiled_s,
        "steps": steps, "host_launches": launches,
        "host_launches_per_step": launches / max(steps, 1),
        "busy_ms": busy_us / 1e3, "idle": 1 - busy_us / 1e6 / profiled_s,
        "likelihood_kernel_ms": sum(e.time_range.elapsed_us() for e in lik) / 1e3,
        "likelihood_kernel_launches": len(lik),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
