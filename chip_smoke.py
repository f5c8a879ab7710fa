#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pnr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and nvcc.
Phases, each of which exits non-zero on failure:

1. device: a CUDA device is present; prints the card's name and power limit;
2. build: compiles pnr_tpu_torch/csrc/*.cu and launches each kernel once;
3. K1 (frangi3d_fused) against its plain PyTorch version on the card:
   clean and noisy tube volumes (64, 256, 256) and the main path's
   (128, 640, 640) stack at sigmas (2, 4, 6), then both timed (CUDA
   events, warm-up, median of 5) on that stack;
4. K2 (exact_sums) against its plain version at sigmas (2, 4, 6), step 2:
   on a (64, 256, 256) tube volume a 128-seed wave (T=256 traces x B=20
   particles) and B=1 seed scoring, on the main path's stack one tracer
   chunk (T=128, B=20) and 173-seed scoring (B=1), with queries along the
   tube axis; both versions timed at T=256, B=20;
5. main path: the 52.4-Mvox (128, 640, 640) stack of bench.py's
   make_volume through the port's CLI in-process with
   `-p 2,4,6 0 10 0.5 3 2 100 20 2 4 9 --device cuda`, twice. The SWC must
   lie on the tube axis and both kernels' launch counters must have risen
   during the first run;
6. profile: a third run of the main path under torch.profiler; prints the
   card's busy time, its idle share, each kernel's device time and the
   host's kernel-launch calls;
7. the same path on a small stack on the card and on the CPU (plain
   versions) must agree.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SIGMAS = (2.0, 4.0, 6.0)
ZDIST = 2.0
MAIN_SHAPE = (128, 640, 640)
MAIN_PARAMS = ["2,4,6", "0", "10", "0.5", "3", "2", "100", "20", "2", "4", "9"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def make_volume(shape, seed=0):
    """bench.py's make_volume: a bright x-aligned tube, sinusoidally
    modulated, with Gaussian noise (sigma 5)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] / 2) ** 2 + ((z - shape[0] / 2) * ZDIST) ** 2
    vol = 200.0 * np.exp(-d2 / (2 * 9.0)) * (0.7 + 0.3 * np.sin(x / 4.0))
    return np.clip(vol + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


def tube(shape, noise=0):
    rng = np.random.default_rng(3)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] / 2) ** 2 + ((z - shape[0] / 2) * ZDIST) ** 2
    v = 200.0 * np.exp(-d2 / (2 * 9.0))
    if noise:
        v = v + rng.integers(0, noise, shape)
    return np.clip(v, 0, 255).astype(np.uint8)


def time_ms(torch, fn, reps=5):
    """Median device time of `fn` over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return card


def phase_build(torch):
    from pnr_tpu_torch.ops import cuda
    from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused
    from pnr_tpu_torch.ops.zncc_exact import ExactPatchEngine, ZnccTemplates

    t0 = time.perf_counter()
    path = cuda.build()
    cuda.library()
    print(f"[build] {os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.3f} s", flush=True)
    dev = torch.device("cuda")
    vol = torch.from_numpy(tube((8, 24, 24), noise=20)).to(dev)
    frangi3d_fused(vol, (2.0,), ZDIST)
    eng = ExactPatchEngine(ZnccTemplates((2.0,), False), 2, dev)
    pos = torch.tensor([[[12.0, 12.0, 4.0]]], device=dev)
    dirs = torch.tensor([[[1.0, 0.0, 0.0]]], device=dev)
    eng.eval_fused(vol, pos, dirs)
    torch.cuda.synchronize()
    print("[build] both kernels launched at a tiny shape", flush=True)


def dirs_aligned(torch, j_ref, jmax, va, vb):
    """Median |cos| between two sets of uint8 directions, and the share
    above 0.9, over the voxels where J > 0.2 Jmax."""
    m = j_ref > 0.2 * float(jmax)

    def dec(a):
        return a[m].to(torch.float32) / 255.0 * 2.0 - 1.0

    dot = sum(dec(a) * dec(b) for a, b in zip(va, vb)).abs()
    return float(dot.median()), float((dot > 0.9).float().mean())


def k1_compare(torch, label, vol):
    """K1 against the plain chain on the card; returns the numbers and the
    J8 difference."""
    from pnr_tpu_torch.ops.frangi import frangi3d, normalize_to_u8
    from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused

    k = frangi3d_fused(vol, SIGMAS, ZDIST)
    p = frangi3d(vol, SIGMAS, ZDIST)
    scale = max(float(p[2]), 1e-12)
    max_abs = float((k[0] - p[0]).abs().max())
    r = {
        "max_abs": max_abs,
        "rel": max_abs / scale,
        "jmin": abs(float(k[1]) - float(p[1])) / scale,
        "jmax": abs(float(k[2]) - float(p[2])) / scale,
    }
    r["med"], r["frac"] = dirs_aligned(torch, p[0], p[2], p[3:], k[3:])
    d8 = (normalize_to_u8(*k[:3]).int() - normalize_to_u8(*p[:3]).int()).abs()
    r["j8_max"], r["j8_mis"] = int(d8.max()), float((d8 > 0).float().mean())
    print(f"[K1] {label} {tuple(vol.shape)}: max|dJ| {max_abs:.3e}, max|dJ|/Jmax "
          f"{r['rel']:.3e}, Jmin {float(k[1]):.6g} vs {float(p[1]):.6g}, Jmax "
          f"{float(k[2]):.6g} vs {float(p[2]):.6g}, J8 max diff {r['j8_max']} mismatch "
          f"{r['j8_mis']:.3e}, dir median {r['med']:.5f} frac {r['frac']:.5f}", flush=True)
    return r


def phase_k1(torch, card, main_vol):
    from pnr_tpu_torch.ops.frangi import frangi3d
    from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused

    dev = torch.device("cuda")
    r = k1_compare(torch, "clean tube", torch.from_numpy(tube((64, 256, 256))).to(dev))
    check(r["rel"] < 1e-4, "K1 clean tube max|dJ|/Jmax < 1e-4")
    check(r["jmin"] < 1e-4 and r["jmax"] < 1e-4, "K1 clean tube Jmin and Jmax")
    check(r["med"] > 0.99 and r["frac"] == 1.0, "K1 clean tube directions")

    r = k1_compare(torch, "noisy tube", torch.from_numpy(tube((64, 256, 256), noise=40)).to(dev))
    check(r["j8_max"] <= 8 and r["j8_mis"] < 0.01, "K1 noisy tube J8 bars")
    check(r["med"] > 0.99 and r["frac"] > 0.95, "K1 noisy tube directions")

    # the main path's stack: the J bars of the clean tube, and (make_volume
    # carries Gaussian noise) the J8 and direction bars of the noisy one
    r = k1_compare(torch, "main stack", main_vol)
    check(r["rel"] < 1e-4, "K1 main stack max|dJ|/Jmax < 1e-4")
    check(r["jmin"] < 1e-4 and r["jmax"] < 1e-4, "K1 main stack Jmin and Jmax")
    check(r["j8_max"] <= 8 and r["j8_mis"] < 0.01, "K1 main stack J8 bars")
    check(r["med"] > 0.99 and r["frac"] > 0.95, "K1 main stack directions")
    max_abs = r["max_abs"]

    ms = time_ms(torch, lambda: frangi3d_fused(main_vol, SIGMAS, ZDIST))
    plain_ms = time_ms(torch, lambda: frangi3d(main_vol, SIGMAS, ZDIST))
    mvox = main_vol.numel() / 1e6
    print(f"[K1] {MAIN_SHAPE} sigmas {SIGMAS}: kernel {ms:.3f} ms ({mvox / ms * 1e3:.1f} Mvox/s), "
          f"plain {plain_ms:.3f} ms [{card}]", flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def k2_queries(rng, shape, t, b, axis_sd):
    """Trace clouds centred near the tube axis (a quarter anywhere, to
    reach the borders), B particles within 4 voxels of each centre, half
    of the directions roughly along the tube (x)."""
    l, h, w = shape
    centre = np.stack([rng.uniform(0, w - 1, t), rng.normal(h / 2, 2 * axis_sd, t),
                       rng.normal(l / 2, axis_sd, t)], -1)
    anywhere = rng.random(t) < 0.25
    centre[anywhere] = np.stack([rng.uniform(0, w - 1, t), rng.uniform(0, h - 1, t),
                                 rng.uniform(0, l - 1, t)], -1)[anywhere]
    pos = centre[:, None, :] + (rng.uniform(-4, 4, (t, b, 3)) if b > 1 else 0.0)
    d = rng.normal(size=(t, b, 3))
    d[: t // 2, :, 0] += 4.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos.astype(np.float32), d.astype(np.float32)


def phase_k2(torch, card, main_vol):
    from pnr_tpu_torch.ops.zncc_exact import (
        ExactPatchEngine, ZnccTemplates, exact_corr_from_sums, exact_sums, exact_sums_plain,
    )

    dev = torch.device("cuda")
    eng = ExactPatchEngine(ZnccTemplates(SIGMAS, False), 2, dev)
    rng = np.random.default_rng(11)
    tube_vol = torch.from_numpy(tube((64, 256, 256), noise=40)).to(dev)
    worst = 0.0
    timing = None
    # (volume, T, B, spread of the centres about the axis in z)
    cases = (("tube", tube_vol, 256, 20, 1.0), ("tube", tube_vol, 512, 1, 1.0),
             ("main stack", main_vol, 128, 20, 1.0), ("main stack", main_vol, 173, 1, 0.5))
    for label, vol, t, b, axis_sd in cases:
        pos, d = k2_queries(rng, tuple(vol.shape), t, b, axis_sd)
        p = torch.from_numpy(pos).to(dev)
        dd = torch.from_numpy(d).to(dev)
        corner = eng.corners(vol.shape, p.mean(dim=1))
        qs = eng.qinfo(vol, corner, p, dd)
        dims = eng.dims(vol.shape)
        sk = exact_sums(vol, corner, qs, eng.tables, dims)
        sp = exact_sums_plain(vol, corner, qs, eng.tables, dims)
        col_err = [float((sk[..., i] - sp[..., i]).abs().max()) /
                   max(float(sp[..., i].abs().max()), 1.0) for i in range(3)]
        ck, sgk = exact_corr_from_sums(eng.tables, sk)
        cp, sgp = exact_corr_from_sums(eng.tables, sp)
        cerr = float((ck - cp).abs().max())
        agree = float((sgk == sgp).float().mean())
        worst = max(worst, cerr)
        print(f"[K2] {label} {tuple(vol.shape)} T={t} B={b} patch {dims}: sums max|d|/max|plain| "
              f"per column {', '.join(f'{e:.3e}' for e in col_err)}; corr max|d| {cerr:.3e}; "
              f"sigma agreement {agree:.4f}", flush=True)
        check(max(col_err) < 1e-5, f"K2 {label} T={t} B={b}: sums within 1e-5 of each column's scale")
        check(cerr < 3e-4 and agree > 0.97,
              f"K2 {label} T={t} B={b}: corr atol 3e-4 and sigma agreement > 97%")
        if timing is None:
            timing = (
                time_ms(torch, lambda: exact_sums(vol, corner, qs, eng.tables, dims)),
                time_ms(torch, lambda: exact_sums_plain(vol, corner, qs, eng.tables, dims)),
            )
    ms, plain_ms = timing
    print(f"[K2] tube T=256 B=20 sigmas {SIGMAS}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"[{card}]", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def cli_argv(src, workdir, run):
    return ["-i", src, "-p", *MAIN_PARAMS, "--device", "cuda",
            "-o", os.path.join(workdir, f"run{run}.swc"),
            "--metrics", os.path.join(workdir, f"run{run}.json"), "--quiet"]


def phase_main(torch, card, src, workdir):
    from pnr_tpu_torch import cli
    from pnr_tpu_torch.ops import frangi_fused, zncc_exact

    launches = wall = None
    for run in (1, 2):
        swc = os.path.join(workdir, f"run{run}.swc")
        metrics = os.path.join(workdir, f"run{run}.json")
        argv = cli_argv(src, workdir, run)
        if run == 1:
            frangi_fused.LAUNCHES = 0
            zncc_exact.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        if run == 1:
            launches = {"frangi3d_fused": frangi_fused.LAUNCHES,
                        "exact_sums": zncc_exact.LAUNCHES}
        check(rc == 0, f"CLI run {run} exited {rc}")
        rows = np.loadtxt(swc, comments="#", ndmin=2)  # id type x y z r parent
        entry = json.load(open(metrics))["stacks"][0]
        ys, zs = rows[:, 3], rows[:, 4]
        print(f"[main] run {run}: {e2e:.3f} s end to end, {len(rows)} SWC nodes, median y "
              f"{np.median(ys):.3f} z {np.median(zs):.3f}, seeds {entry.get('n_raw_seeds')} raw / "
              f"{entry['n_seeds']} selected, {entry['trace_count']} traces [{card}]", flush=True)
        print(f"[main] run {run} stages (s): {json.dumps(entry['timings_s'])}", flush=True)
        check(len(rows) > 10, "main path SWC has more than 10 nodes")
        check(abs(np.median(ys) - MAIN_SHAPE[1] / 2) <= 3, "median node y within 3 of 320")
        check(abs(np.median(zs) - MAIN_SHAPE[0] / 2) <= 3, "median node z within 3 of 64")
        if run == 1:
            print(f"[main] kernel launches during run 1: {json.dumps(launches)}", flush=True)
            check(all(v > 0 for v in launches.values()),
                  "both kernels were launched by the main path")
        wall = e2e
    return launches, wall


def phase_profile(torch, card, src, workdir, unprofiled_s):
    """A third main-path run under torch.profiler: the card's busy time
    (union of its kernel and copy spans), idle share, per-kernel device
    time and the host's kernel-launch calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pnr_tpu_torch import cli

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(cli_argv(src, workdir, 3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"profiled CLI run exited {rc}")
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("Activity Buffer")]
    check(dev, "the profiler recorded device work in the main path")
    busy_us, end = 0.0, -1.0
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_s = busy_us / 1e6

    def device_ms(*names):
        hit = [e for e in dev if any(n in e.name for n in names)]
        return sum(e.time_range.elapsed_us() for e in hit) / 1e3, len(hit)

    k1_ms, k1_n = device_ms("gauss1d_kernel", "frangi_scale_kernel", "decode_stats_kernel")
    k2_ms, k2_n = device_ms("exact_sums_kernel")
    host_launch = [e for e in events if e.device_type == DeviceType.CPU
                   and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")]
    launch_ms = sum(e.time_range.elapsed_us() for e in host_launch) / 1e3
    print(f"[profile] run 3 under torch.profiler: {wall:.3f} s; card busy {busy_s * 1e3:.3f} ms, "
          f"idle {1 - busy_s / wall:.4f} of the profiled run and "
          f"{1 - busy_s / unprofiled_s:.4f} of run 2's {unprofiled_s:.3f} s [{card}]", flush=True)
    print(f"[profile] K1 {k1_ms:.3f} ms in {k1_n} launches, K2 {k2_ms:.3f} ms in {k2_n} "
          f"launches; {len(dev)} device ops; {len(host_launch)} host kernel-launch calls "
          f"taking {launch_ms:.3f} ms", flush=True)
    check(k1_n > 0 and k2_n > 0, "the profiler saw both kernels on the main path")
    top = prof.key_averages().table(sort_by="self_device_time_total", row_limit=15)
    print("[profile] top device ops:\n" + top, flush=True)


def phase_small_agreement(torch):
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruction_func

    vol = make_volume((24, 64, 96), seed=7)
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                    ni=100, np=20, zdist=ZDIST, nodepervol=4, vol=9)
    gpu = reconstruction_func(vol, cfg, verbose=False, device="cuda")
    cpu = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    sg = {tuple(p) for p in gpu.seeds_pos.astype(int).tolist()}
    sc = {tuple(p) for p in cpu.seeds_pos.astype(int).tolist()}
    overlap = len(sg & sc) / max(len(sg), len(sc), 1)
    dy = abs(np.median(gpu.tree.y[1:]) - np.median(cpu.tree.y[1:]))
    dz = abs(np.median(gpu.tree.z[1:]) - np.median(cpu.tree.z[1:]))
    print(f"[small] card vs plain CPU: seed overlap {overlap:.3f}, nodes {len(gpu.tree) - 1} vs "
          f"{len(cpu.tree) - 1}, traces {gpu.trace_count} vs {cpu.trace_count}, median "
          f"|dy| {dy:.3f} |dz| {dz:.3f}", flush=True)
    check(overlap >= 0.9, "small stack: seed sets agree")
    check(len(gpu.tree) > 10 and dy < 2.0 and dz < 2.0, "small stack: trees agree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "pnr_tpu_torch")):
        print("chip_smoke: run from the root of a pnr-tpu checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    card = phase_device(torch)
    phase_build(torch)
    t0 = time.perf_counter()
    main_np = make_volume(MAIN_SHAPE)
    print(f"[main] built the {MAIN_SHAPE} stack in {time.perf_counter() - t0:.3f} s", flush=True)
    main_vol = torch.from_numpy(main_np).cuda()
    k1 = phase_k1(torch, card, main_vol)
    k2 = phase_k2(torch, card, main_vol)
    del main_vol
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
    try:
        src = os.path.join(workdir, "stack.npy")
        np.save(src, main_np)
        launches, run2_s = phase_main(torch, card, src, workdir)
        phase_profile(torch, card, src, workdir, run2_s)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase_small_agreement(torch)
    check("jax" not in sys.modules, "no jax was imported")
    kernels = [
        {"name": "frangi3d_fused", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/frangi_fused.cu",
         "replaces": "pnr_tpu/ops/frangi_fused.py:265",
         "launches": launches["frangi3d_fused"], **k1},
        {"name": "exact_sums", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/zncc_exact.cu",
         "replaces": "pnr_tpu/ops/zncc_exact.py:194",
         "launches": launches["exact_sums"], **k2},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
