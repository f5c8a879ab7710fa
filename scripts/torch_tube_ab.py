#!/usr/bin/env python3
"""The PyTorch port's tube path on one card, for comparing two checkouts.

    python scripts/torch_tube_ab.py [--root DIR]

Runs `pnr_tpu_torch` from the checkout at DIR (this one by default) on
chip_smoke.py's 52.4-Mvox (128, 640, 640) stack with its CLI parameters
and `--zncc-mode tube`: twice without a profiler (the second run's stage
times are the warm ones), then once under torch.profiler. Prints one JSON
line: the second run's seconds and tracing stage, and for the profiled
run the tracer steps (one iteration of one chunk, counted at
`BatchedTracker._estimate`), the host's kernel-launch calls in all and
per step, the card's busy time and idle share, and the device time of the
tube likelihood's kernels (named hat_* or tube_corr_*). It needs a CUDA
device and takes the stack, the parameters and the device from
chip_smoke.py, which it loads from this checkout, so two checkouts run
the same work. To compare a parent commit with a change on one card, run
them in turns (parent, change, change, parent) in one session.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose pnr_tpu_torch runs")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("torch_tube_ab: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    from pnr_tpu_torch import cli
    from pnr_tpu_torch.smc.tracker import BatchedTracker
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not cli.__file__.startswith(root):
        raise RuntimeError(f"pnr_tpu_torch came from {cli.__file__}, not from {root}")
    steps = [0]
    estimate = BatchedTracker._estimate

    def counted(self, *a, **k):
        steps[0] += 1
        return estimate(self, *a, **k)

    BatchedTracker._estimate = counted
    workdir = tempfile.mkdtemp(prefix=".tube_ab_", dir=root)
    try:
        src = os.path.join(workdir, "stack.npy")
        import numpy as np

        np.save(src, cs.make_volume(cs.MAIN_SHAPE))

        def run(tag):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(cs.cli_argv(src, workdir, tag, "tube"))
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"the tube CLI run {tag} exited {rc}")
            return time.perf_counter() - t0

        run("tube1")
        run2_s = run("tube2")
        with open(os.path.join(workdir, "tube2.json")) as f:
            stages = json.load(f)["stacks"][0]["timings_s"]
        steps[0] = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_s = run("tube3")
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
    lik = [e for e in dev if e.name.startswith(("hat_", "tube_corr")) or "::hat_" in e.name
           or "::tube_corr" in e.name]
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(json.dumps({
        "root": root, "card": torch.cuda.get_device_name(0), "run2_s": run2_s,
        "tracing_s": stages.get("tracing"), "stages_s": stages, "profiled_s": profiled_s,
        "steps": steps[0], "host_launches": launches,
        "host_launches_per_step": launches / max(steps[0], 1),
        "busy_ms": busy_us / 1e3, "idle": 1 - busy_us / 1e6 / profiled_s,
        "likelihood_kernel_ms": sum(e.time_range.elapsed_us() for e in lik) / 1e3,
        "likelihood_kernel_launches": len(lik),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
