#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pnr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and nvcc.
Phases, each of which exits non-zero on failure:

1. device: a CUDA device is present; prints the card's name and power limit;
2. build: builds or loads the native host library (g++, its time
   printed; the run fails unless `native.have_native()`, so that no main
   run's seed stage pays the build or falls back to NumPy), compiles
   pnr_tpu_torch/csrc/*.cu, runs K7's check
   (`ops.cuda.self_check`: pnr_probe doubles an (8, 128) block) and
   launches each kernel once (K1, K2, K3, K4, the map build's 1-D
   correlation on K3, tube_corr) at a tiny shape, and times K7's `pnr_probe`
   in turns with its plain version and `torch.mul` (per call in runs of
   20 back-to-back calls, and alone), and the device time of one launch of
   each from torch.profiler;
3. K1 (frangi3d_fused, one plane-ring pass per sigma) against its plain
   PyTorch version on the card: clean and noisy tube volumes
   (64, 256, 256) and the main path's (128, 640, 640) stack at sigmas
   (2, 4, 6), with each sigma's tile and shared memory, then both timed
   (CUDA events, warm-up, median of 5) on that stack;
4. K3 (conv1d_axis) and K4 (conv_yx) against their plain versions on the
   main stack, as float32 and as uint8, with the taps of the unfused
   filter (K3 along each axis, K4 at sigmas 2, 4 and 6): max|kernel -
   plain| / max|plain| < 1e-5; both timed with their plain versions and a
   cuDNN conv3d (TF32 off); K3 also timed at 3 taps along each axis; K4
   timed from uint8 at each sigma in turns with K3 along y then K3 along x
   (the two launches it fuses; per call back to back and alone), beside
   its bound, and its sigma-6 uint8 output's SHA-256 printed;
5. unfused: `frangi3d` on the card (K4, K3) against `frangi3d_plain` at
   K1's bars on the tube volumes and the main stack, timed next to K1, with
   the peak device bytes per voxel of K1, the unfused and the tiled route;
   tiled: `frangi3d_tiled` at (32, 160) and (48, 200) and
   `frangi3d_blocked` at 32 bitwise the monolithic `frangi3d`;
6. K2 (exact_sums, one thread-block cluster per trace) against its plain
   version at sigmas (2, 4, 6), step 2: on a (64, 256, 256) tube volume a
   128-seed wave (T=256 traces x B=20 particles) and B=1 seed scoring, on
   the main path's stack one tracer chunk (T=128, B=20), 173-seed scoring
   and one estimate chunk (T=128, B=1), with queries along the tube axis;
   each case bitwise equal over two launches, printed with its slabs per
   trace and shared memory per block, and timed per call in runs of 20;
   at T=256, B=20 also alone, in turns with a `grid_sample` of the f32
   volume at the same samples' coordinates (sampling only), and the plain
   version; the profile phase adds K2's device time per exact run;
7. tube map build on the main path's stack at sigmas (2, 4, 6): the
   packed field through K3 against the plain shift-and-add
   (per channel max|d| / max(|plain|, 1) < 1e-5), both timed;
8. tube_corr (K5's and K6's counterpart) against its plain chain on that
   field: the tracer's evaluation of one chunk (T=128, N=20, the group
   windows) with queries around the tube axis, a quarter anywhere (K5's
   row); seed scoring in one sigma_max window (K6's row) on 173 B=1 seeds
   along the axis and T=512 B=1 anywhere, also against the group windows.
   Bars: line sums within 1e-5 of each column's scale, corr max|d| < 1e-4,
   sigma agreement > 0.99; both rows timed in turns with one `grid_sample`
   call on the field at the same rows' global coordinates (CUDA events, so
   the wrapper's host cost is included: per call in runs of 20 back-to-back
   calls, the kernels line's `ms`, and alone; and per call inside a
   captured CUDA graph of 20 calls, `graph_ms` and `library_graph_ms`),
   their device time per launch read from torch.profiler, and the plain
   chain timed; then [threefry]: the tracer's draws' kernel (csrc/
   threefry.cu) bitwise its plain version and the host draws at the main
   path's shapes (T=128, np 20, 8 and 16 iterations a stage; `trace_init`'s
   one draw), timed with its plain version beside the host draws
   (`stage_uniforms`) that the stages made before the draws moved to the
   card;
9. bf16 field: a forced bfloat16 field on a (64, 256, 256) noisy tube:
   tube_corr against its plain chain on it at the bars above, and the
   field against the float32 one: corr max error < 8e-3, sigma flips < 3%;
10. main paths: the 52.4-Mvox (128, 640, 640) stack of bench.py's
   make_volume through the port's CLI in-process with
   `-p 2,4,6 0 10 0.5 3 2 100 20 2 4 9 --device cuda`, twice in exact mode
   and twice with `--zncc-mode tube`, and through `reconstruction_func`
   twice with `fused_frangi=False` (the unfused filter on K4 and K3), then
   once more with the unfused cap lowered so the tiled engine runs (its J8
   and seeds must be the monolithic run's). Each SWC must lie on the tube
   axis, and the kernels of each path must have been launched by its first
   run (launch counts set to 0 just before it and read just after; K1
   once per sigma plus its decode);
11. profile: one more run of each path under torch.profiler; prints the
   card's busy time, its idle share, each kernel's device time (K1 and K3
   per run of each path also on one line), the host's launch calls
   (kernel launches and `cudaGraphLaunch`) per tracer step, one step being
   one iteration of one chunk, the `cudaStreamSynchronize` calls per
   tracer stage, and in tube mode the device time per tube_corr launch;
   [graphs exact], [graphs tube]: the main stack through
   `reconstruction_func` on three routes of the tracer in turns, three
   runs each: eager stages (`BatchedTracker(..., graphs=False)`), CUDA
   graphs captured at each key's first stage (PNR_TPU_NO_WARM_ASYNC=1)
   and graphs captured by the warm thread while the front runs (the
   default; smc/graphs.py): trees, n0, seeds and trace counts bitwise, two
   keys, no capture on the tracing thread with the warm thread, the
   tracer's launches two a `trace_init` and 2 x STAGE_ITERS a stage and
   the draws' one a `trace_init` and one a stage (the eager route's plus
   the warm thread's `trace_init`); each run's seconds and tracing
   seconds, stages by route, the warm thread's captures, seconds and
   overlap with the front, the graphs' memory, the tracing thread's host
   milliseconds per stage it dispatched, split into the wave loop's
   commits (every route; their `tracing.commit` spans) and, on the
   graph routes, the staging writes, the replay call and the fetch wait, then
   one eager run under the profiler (the warm route's profile is the phase
   above);
12. the exact and tube paths on a small stack on the card and on the CPU
   (plain versions) must agree; no module of jax or of pnr_tpu was loaded;
13. [K2 2d], [maps 2d], [tube_corr 2d]: on the 2-D main plane (1, 4096,
   4096) (make_volume, one plane): K2 on one-plane patches (pz = 1) for a
   tracer chunk (T=128, B=20) and B=1 scoring at K2's bars, bitwise over
   two launches, with its slabs, shared memory and times; the 2-D map
   build (y and x passes on K3) within 1e-5, and K3 on the plane timed;
   tube_corr on one-plane windows for the tracer and scoring rows at its
   bars, timed as in phase 8;
14. [soma]: `soma_extraction` on the card and on the CPU plain path on the
   main stack with two soma blobs (multi_neuron_soma_phantom's recipe at x
   = 160 and 480), somaradius 4: the eroded, smoothed stack bitwise, and
   the soma maps, thresholds and soma nodes equal; the stage's time, its
   parts, threshold and regions printed;
15. [main soma]: the CLI on that stack with
   `-p 2,4,6 4 10 0.5 3 2 100 20 2 4 9`: SOMA nodes in the SWC, stage
   timings and run 1's launches of K1, K2 and K3;
16. [main 2d exact], [main 2d tube]: the CLI on the 2-D main plane with
   `-p 2,4,6 0 10 0.5 3 2 100 20 1 4 9`, twice, then once under the
   profiler: the SWC's median y within 2 of 2048 and every z 0, K3 and K2
   (exact) or K3 and tube_corr (tube) launched, and no K1;
17. [tiled 2d]: `frangi2d_tiled` at `pick_blocks_2d`'s blocks bitwise
   `frangi2d` on a (1, 9216, 9216) plane (85 Mpx, over the 80-Mpx
   cutover), with both routes' peak device bytes per pixel;
18. [quality]: branching_neuron_phantom_2d (exact and tube),
   multi_neuron_soma_phantom (somaradius 4) and branching_neuron_phantom
   (exact) through the pipeline on the card and on the CPU plain path,
   scored against gold with the port's `compare_swc` (tests/
   _torch_phantoms.py, imported with tests/ on sys.path): the card's F1
   within 0.05 of the CPU's and each phantom test's own bars on the card;
19. [batch exact], [batch tube]: four stacks (make_volume(MAIN_SHAPE,
   seed=i)) through `reconstruction_batch`, prefetch on and off in turns
   (on, off, off, on): every batch's trees bitwise the one-by-one run's and
   its launches equal, each stack's seconds, peak device bytes and K1, K2,
   K3 and tube_corr launches, the share of the fronts the prefetch hid, and
   the prefetched batch's peak within a single run's plus two fronts'
   modelled peaks (`front_device_bytes`); per stack the stage-graph
   captures on the tracing thread (none after the first stack), replays
   and the warm thread's captures and seconds;
20. [serve]: `watch_and_reconstruct` on a directory with stacks 0 and 1,
   stack 2 written after the first SWC, then `.stop`: three SWCs, each the
   text of the exact batch's tree for its index;
21. [checkpoint]: the exact main stack with a checkpoint after every wave
   (the waves, bytes and seconds of each write), and a run cut by the trace
   cap, checkpointed and resumed: bitwise the uninterrupted run;
22. [midres]: the CLI with --save-midres on the main stack: every artifact
   of pnr_tpu's list, and `_J8.tif` the batch's J8;
23. [sharded filter]: `frangi3d_sharded` over a virtual mesh of four
   shards on cuda:0 (`Mesh((cuda:0,) * 4)`) on the main stack at sigmas
   (2, 4, 6): J, Jmin, Jmax, Vx, Vy, Vz bitwise the monolithic unfused
   filter on the card; K4's and K3's launches and the milliseconds;
24. [sharded exact], [sharded tube]: `reconstruction_func_sharded` on the
   main stack over that mesh, three times, on the tracer's two routes in
   turns (graphs, eager, graphs: each shard's stages replayed as CUDA
   graphs under its slab's frame, or `BatchedTracker(..., graphs=False)`),
   the last two under the profiler: every run bitwise run 1, the two
   routes' kernel launches equal, stage graphs captured and replayed on
   the graph route only; each run's seconds, tracing seconds, captures and
   replays, run 1's stages, SWC nodes, handoffs, kept-local, lost and
   re-queued traces, launches of K2 (or tube_corr), K3 and K4 (each above
   0, K1 none), the peak device bytes within 4 x `plan_sharded`'s
   per-shard estimate, SWC F1 >= 0.85 against the single-device CLI run
   of [main exact]/[main tube] (same key), handoffs > 0 and no trace
   lost; each route's host launch calls a tracer step and the card's busy
   milliseconds a stage;
25. [sharded 2d]: a (1, 2048, 2048) plane of make_volume's recipe over
   four Y shards, exact: J8 the single-device run's, F1 >= 0.85;
26. [sharded checkpoint]: a (32, 256, 256) stack over the mesh cut by the
   trace cap, checkpointed and resumed: bitwise the uninterrupted run;
27. [sharded cards]: with two or more cards, the main stack over
   min(4, count) real cards, bitwise the virtual mesh's tree and each
   card's peak under its plan; with one card it says it was not run;
28. [plan]: `--plan --mesh 4` and `--plan` through the CLI on the main
   stack against the card's memory, `min_devices` for a 2048^3 exact
   stack, the per-shard peak of tests/test_plan.py's (512, 1024, 1024)
   falling strictly over 1, 2, 4 and 8 cards in tube and exact mode, and
   the main stack's four-shard halo slabs on the monolithic filter;
29. [batch dp exact], [batch dp tube]: the four stacks of [batch] through
   `reconstruction_batch_dp` on a virtual mesh of four shards on cuda:0
   (one stack a shard), three times on the tracer's two routes in turns
   as in phase 24 (each stack's lockstep stages replayed as CUDA graphs,
   or eager; every run bitwise run 1, equal launches, captures and
   replays, host calls a tracer step), then `reconstruction_batch` with
   `fused_frangi=False`, prefetch on and off: each stack at JAX's bar
   against the one-by-one run (J8 bitwise, equal node, tree and trace
   counts and node types, positions within 1e-4; whether the trees are
   bitwise too), seconds per stack of the three, the launches of K4, K3,
   K2 or tube_corr (no K1); exact also prints, as information, the J8
   differences from the default config's (K1) batch of [batch exact];
30. [batch dp 2d]: two (1, 4096, 4096) planes the same way (frangi2d on
   K3, K2), batch DP once, on the graph route;
31. [batch sharded]: two stacks through `reconstruction_batch_sharded`,
   two groups of two shards of a four-shard virtual mesh, each group on
   its own host thread and stream, on the tracer's two routes in turns as
   in phase 24 (on the graph route the group threads capture their
   shards' stage graphs at once): each at JAX's bar against
   `reconstruction_func_sharded` on a two-shard mesh, seconds per stack;
32. [serve sharded]: two stacks served through the CLI's `--watch --mesh
   2` (the CLI's `make_mesh` given a two-shard virtual mesh, the card
   being one): each SWC the one-shard sharded run's;
33. [multiprocess]: the main stack, exact, in two processes of a gloo
   group (this script with `--mp-child RANK PORT WORKDIR DEVICE`), each
   with two shards on cuda:0, twice: J8 and node types bitwise, node
   coordinates within 1e-4 and the trace count equal to the
   single-process four-shard run of [sharded exact]; each run's seconds,
   the bytes each stage received from the other process, and both
   processes' launches;
34. [flood]: the device seed flood (`max_points_device`, JAX's label
   propagation as torch ops, the no-native route) on the card on the main
   exact path's J8 against the native flood: equal seed counts per slice,
   >= 95% of positions exact, every divergent seed within 2 px (JAX's
   bound); on an (8, 240, 240) crop the card's mask bitwise the CPU run of
   the same function; both floods timed;
35. [no-native]: one exact run of `reconstruction_func` on the main stack
   with `native.have_native` forced False (the native floods refused): one
   device flood, on the card, whose mask is [flood]'s; K1 and K2 launched;
36. [sharded step], [trace_wave]: `build_sharded_step` (a wave of 64 seeds,
   16 a shard in 34 lanes) on the main stack over the virtual mesh, exact
   and tube: J8 bitwise the sharded pipeline's ([sharded exact]'s), each
   shard's seeds the strongest of the card flood of its planes, the
   stitched traces bitwise `BatchedTracker.trace_wave` on the whole stack
   with the same ids and key, and `trace_wave` staged bitwise unstaged;
   K4, K3 and K2 or tube_corr launched by the step, K2 or tube_corr by the
   wave, no K1;
37. [alt]: `frangi3d_with_scale` on the main stack (J bitwise `frangi3d`'s;
   one K4 and ten K3 launches a sigma) and `extract3d_alt` with the 20,000
   strongest J8 voxels as candidates: seeds on the tube axis, ZNCC above
   0.5, sorted by score, K4 and K3 launched and no K1;
38. [host]: the CLI with `--device cuda` and with PNR_TPU_HOST_PATH=1 (the
   host one-shot engine) on a (64, 256, 256) stack, each in a fresh
   process, exact and tube: both SWCs on the tube axis, each process's
   seconds.

The line before the last is a JSON object describing each kernel (its
launches on its path, error, times, bound and library time; the 2-D and
soma paths' launches and the one-plane rows' times under `launches_2d`,
`launches_soma` and `plane`, the sharded paths' run-1 launches under
`launches_sharded_exact` and `launches_sharded_tube`, and the launches of
phases 29-33 under `launches_batch_dp_exact`, `launches_batch_dp_tube`,
`launches_batch_dp_2d`, `launches_batch_sharded`, `launches_serve_sharded`
and `launches_multiprocess`, and those of phases 35-37 under
`launches_no_native`, `launches_sharded_step_exact`,
`launches_sharded_step_tube`, `launches_trace_wave_exact`,
`launches_trace_wave_tube` and `launches_alt`, and the graph replays of
the tracer's stages in run 1 of the exact and tube main paths under
`replays_exact` and `replays_tube`, and the captures of their warm
threads under `warm_captures_exact` and `warm_captures_tube`, and the
stage graphs replayed on the mesh paths (phases 24 and 29-33, their
graph route's run) under `replays_sharded_exact`, `replays_sharded_tube`,
`replays_batch_dp_exact`, `replays_batch_dp_tube`, `replays_batch_dp_2d`,
`replays_batch_sharded`, `replays_serve_sharded` and
`replays_multiprocess`; the row
`threefry` is the tracer's draws, no TPU kernel's counterpart: its
`replaces` names JAX's `_uniforms`, its times are at the exact stage's
shape with every shape under `shapes`, and its launches are those of
every path above); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SIGMAS = (2.0, 4.0, 6.0)
ZDIST = 2.0
MAIN_SHAPE = (128, 640, 640)
MAIN_PARAMS = ["2,4,6", "0", "10", "0.5", "3", "2", "100", "20", "2", "4", "9"]
#: the 2-D main path: one plane of bench.py's recipe (16.8 Mpx), zdist 1
PLANE_SHAPE = (1, 4096, 4096)
PLANE_PARAMS = ["2,4,6", "0", "10", "0.5", "3", "2", "100", "20", "1", "4", "9"]
#: the soma path: the main stack with two soma blobs, somaradius 4
SOMA_PARAMS = ["2,4,6", "4", "10", "0.5", "3", "2", "100", "20", "2", "4", "9"]
SOMA_X = (160, 480)
#: a plane over the 2-D filter's 80-Mpx tiling cutover (85 Mpx)
TILED_PLANE_SHAPE = (1, 9216, 9216)
#: the device every phase runs on (the kernels need a CUDA device)
DEVICE = "cuda"
#: the card's published peaks (H100 SXM, NVIDIA's data sheet): device
#: memory bytes/s and float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
#: FLOP-equivalents per voxel and sigma of the eigensolve, vesselness and
#: merge (~150 arithmetic FLOPs plus acos, two cos, five sqrt, three exp
#: and a dozen divisions at ~8 each)
EIG_FLOPS = 250
#: FLOPs of one K2 template sample: its patch coordinate (8 fused
#: multiply-adds, clamps, floors), the trilinear sample (7 lerps) and the
#: three sums
K2_SAMPLE_FLOPS = 60
#: FLOPs of one K2 template sample on a one-plane patch: K2_SAMPLE_FLOPS
#: less the z coordinate (2 fused multiply-adds, a clamp, a floor and the
#: fraction: 8) and four of the seven lerps (3 each): the y and x
#: coordinates, the bilinear sample (3 lerps) and the three sums
K2_PLANE_SAMPLE_FLOPS = K2_SAMPLE_FLOPS - 8 - 4 * 3
#: FLOPs of one tube_corr line sample: its point and window coordinates
#: (3 multiplies, 3 adds, 3 subtractions, 12 clamps), six hat weights, four
#: z-y weight products, 24 fused multiply-adds, the x contraction of three
#: channels, the mask and the sum over the line (3 + 3)
HAT_ROW_FLOPS = 112
#: FLOPs of one tube_corr line sample in a one-plane window: HAT_ROW_FLOPS
#: less the z coordinate (a multiply, an add, a subtraction, 4 clamps: 7),
#: the two z hat weights (8), the four z-y weight products (the y weight is
#: the tap weight) and 12 of the 24 fused multiply-adds (24)
HAT_ROW_PLANE_FLOPS = HAT_ROW_FLOPS - 7 - 8 - 4 - 24
#: FLOPs of one tube ZNCC per query and sigma from its three sums: 10
#: arithmetic, a clamp, the gate, a division and a square root (~8 each)
#: and the running max
ZNCC_FLOPS = 30
#: 32-bit integer operations/s outside the tensor cores: 64 INT32 lanes an
#: SM (half its 128 float32 lanes), 132 SMs, at the clock of the float32
#: peak (PEAK_F32_FLOP_S = 132 x 128 x 2 FLOPs x 1.98 GHz)
PEAK_INT32_OP_S = 132 * 64 * 1.98e9
#: 32-bit integer operations of one Threefry-2x32 hash: 20 rounds of an
#: add, a rotate by a constant (one funnel shift) and a xor; six key
#: injections of two adds each (`x1 += k + c` is one three-input add); the
#: third key (one three-input xor)
THREEFRY_HASH_OPS = 20 * 3 + 6 * 2 + 1


def threefry_ops(n_it, t, npart):
    """(32-bit integer operations, float32 operations) the tracer's draws
    need for n_it iterations of t traces at npart draws each: a fold_in
    hash per (trace, step), two steps an iteration; a counter hash per
    draw, npart + 1 an iteration; per draw the halves' xor and the
    mantissa bits (a shift and an or), then a subtraction and a clamp."""
    draws = n_it * t * (npart + 1)
    hashes = n_it * t * 2 + draws
    return hashes * THREEFRY_HASH_OPS + draws * 3, draws * 2


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


def make_soma_volume(shape, seed=0):
    """make_volume's stack with two soma blobs on the tube axis at x in
    SOMA_X, drawn by multi_neuron_soma_phantom's recipe (tests/
    _torch_phantoms.py): a Gaussian of sd 5 voxels, z scaled by zdist, at
    1.2x the tube's peak (200), combined by maximum before the noise."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] / 2) ** 2 + ((z - shape[0] / 2) * ZDIST) ** 2
    vol = 200.0 * np.exp(-d2 / (2 * 9.0)) * (0.7 + 0.3 * np.sin(x / 4.0))
    for sx in SOMA_X:
        np.maximum(vol, 1.2 * 200.0 * np.exp(-(d2 + (x - sx) ** 2) / (2 * 5.0**2)), out=vol)
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


def time_turns_ms(torch, fns, reps=21, calls=1, warmup=5):
    """Median device time per call of each of `fns`, each rep timing
    `calls` back-to-back calls, the functions in turns (in order, then in
    reverse, ...) after `warmup` calls of each. A launch-bound call's event
    time is mostly its host cost, which moves with the host's state (what
    ran just before): turns give each the same conditions."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return [statistics.median(t) for t in times]


def graph_turns_ms(torch, fns, calls=20, reps=21):
    """Device time per call of each of `fns` inside a CUDA graph of `calls`
    calls: each graph captured once (after a warm-up call), then replayed
    between CUDA events, the graphs in turns as in `time_turns_ms`
    (median). The replay has no per-call host cost."""
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[i].replay()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return [statistics.median(t) for t in times]


def bound(nbytes, flops, int_ops=0):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over their rates (float32
    FLOPs and 32-bit integer operations), and which of the two sets it."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = (flops / PEAK_F32_FLOP_S + int_ops / PEAK_INT32_OP_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def frangi_flops(n, sigmas, zdist):
    """FLOPs of the multi-scale Frangi on n voxels: 2 per Gaussian tap
    (x, y and z passes), 2 per difference pass (9 per sigma), EIG_FLOPS."""
    from pnr_tpu_torch.ops.gaussian import gaussian_kernel

    per = sum(2 * (2 * len(gaussian_kernel(s)) + len(gaussian_kernel(s / zdist))) + 9 * 2
              + EIG_FLOPS for s in sigmas)
    return n * per


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


def phase_build(torch, card):
    """Build the kernels, run K7's check, launch every kernel once at a tiny
    shape, time K7 in turns with its plain version and `torch.mul`; returns
    K7's launches (its path is this phase: the pipeline routes by the
    tensor's device and never probes)."""
    from pnr_tpu_torch.ops import conv, cuda
    from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused
    from pnr_tpu_torch.ops.gaussian import gaussian_kernel
    from pnr_tpu_torch.ops.zncc_exact import ExactPatchEngine, ZnccTemplates
    from pnr_tpu_torch.ops.zncc_fast import TubePatchEngine, TubeZnccModel, build_tube_maps_packed

    from pnr_tpu_torch import native

    t0 = time.perf_counter()
    native.get_lib()
    print(f"[build] native host library {os.path.relpath(native.library_path(), HERE)} built or "
          f"loaded in {time.perf_counter() - t0:.3f} s, have_native() {native.have_native()}",
          flush=True)
    check(native.have_native(), "the native host library built and loaded (no NumPy fallback)")
    t0 = time.perf_counter()
    path = cuda.build()
    cuda.library()
    print(f"[build] {os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.3f} s", flush=True)
    dev = torch.device(DEVICE)
    cuda.PROBE_LAUNCHES = 0
    cuda.self_check(dev)
    probe_launches = cuda.PROBE_LAUNCHES
    print("[build] K7's check: pnr_probe doubled an (8, 128) block, every value 2.0", flush=True)
    vol = torch.from_numpy(tube((8, 24, 24), noise=20)).to(dev)
    frangi3d_fused(vol, (2.0,), ZDIST)
    conv.conv1d_axis(vol, (-0.5, 0.0, 0.5), 0, grad_border=True)  # K3
    conv.conv_yx(vol, gaussian_kernel(2.0), gaussian_kernel(2.0))  # K4
    eng = ExactPatchEngine(ZnccTemplates((2.0,), False), 2, dev)
    pos = torch.tensor([[[12.0, 12.0, 4.0]]], device=dev)
    dirs = torch.tensor([[[1.0, 0.0, 0.0]]], device=dev)
    eng.eval_fused(vol, pos, dirs)
    model = TubeZnccModel((2.0,), False)
    field = build_tube_maps_packed(vol, model)
    teng = TubePatchEngine(model, 2, ZDIST, device=dev)
    teng.eval_fused(field, pos, dirs)  # tube_corr, scoring
    teng.likelihood(field, teng.window(field, pos[:, 0]), pos, dirs)  # tube_corr, tracer
    torch.cuda.synchronize()
    print("[build] K1, K2, K3, K4, the map build (K3) and tube_corr launched at a tiny shape",
          flush=True)
    x = torch.from_numpy(np.random.default_rng(1).random((8, 128), np.float32)).to(dev)
    fns = (lambda: cuda.probe(x), lambda: cuda.probe_plain(x), lambda: torch.mul(x, 2.0))
    # in turns: per call in runs of 20 back-to-back calls, and alone
    ms, plain_ms, library_ms = time_turns_ms(torch, fns, calls=20)
    single_ms, plain_single_ms, library_single_ms = time_turns_ms(torch, fns, reps=51)
    # the device time of the launch alone, from the profiler: what is left
    # of the event times is the host's call
    dev_ms, seen = device_ms_per_launch(torch, fns[0], kernel="probe_kernel")
    lib_dev_ms, lib_seen = device_ms_per_launch(torch, fns[2], kernel="elementwise_kernel")
    k7 = {"max_abs_err": float((cuda.probe(x) - cuda.probe_plain(x)).abs().max()),
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "single_ms": single_ms,
          "plain_single_ms": plain_single_ms, "library_single_ms": library_single_ms,
          "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
          **bound(2 * x.numel() * 4, x.numel())}
    print(f"[build] K7 (8, 128) in turns: pnr_probe {ms:.4f} ms per call back to back, "
          f"{single_ms:.4f} alone; plain x * 2.0 {plain_ms:.4f}, {plain_single_ms:.4f}; torch.mul "
          f"{library_ms:.4f}, {library_single_ms:.4f}; device time per launch (profiler): "
          f"pnr_probe {dev_ms * 1e3:.3f} us ({seen} launches), torch.mul {lib_dev_ms * 1e3:.3f} us "
          f"({lib_seen}) [{card}]", flush=True)
    return probe_launches, k7


def dirs_aligned(torch, j_ref, jmax, va, vb):
    """Median |cos| between two sets of uint8 directions, and the share
    above 0.9, over the voxels where J > 0.2 Jmax."""
    m = j_ref > 0.2 * float(jmax)

    def dec(a):
        return a[m].to(torch.float32) / 255.0 * 2.0 - 1.0

    dot = sum(dec(a) * dec(b) for a, b in zip(va, vb)).abs()
    return float(dot.median()), float((dot > 0.9).float().mean())


def k1_compare(torch, label, vol, tag="K1"):
    """K1 (or, with tag "unfused", the unfused `frangi3d` on K4 and K3)
    against the plain chain on the card; returns the numbers and the J8
    difference."""
    from pnr_tpu_torch.ops.frangi import frangi3d, frangi3d_plain, normalize_to_u8
    from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused

    k = (frangi3d_fused if tag == "K1" else frangi3d)(vol, SIGMAS, ZDIST)
    p = frangi3d_plain(vol, SIGMAS, ZDIST)
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
    print(f"[{tag}] {label} {tuple(vol.shape)}: max|dJ| {max_abs:.3e}, max|dJ|/Jmax "
          f"{r['rel']:.3e}, Jmin {float(k[1]):.6g} vs {float(p[1]):.6g}, Jmax "
          f"{float(k[2]):.6g} vs {float(p[2]):.6g}, J8 max diff {r['j8_max']} mismatch "
          f"{r['j8_mis']:.3e}, dir median {r['med']:.5f} frac {r['frac']:.5f}", flush=True)
    return r


def frangi_bars(torch, main_vol, tag):
    """K1's bars, for K1 or the unfused filter, on the tube volumes and the
    main stack; returns the main stack's max|dJ|."""
    dev = torch.device(DEVICE)
    r = k1_compare(torch, "clean tube", torch.from_numpy(tube((64, 256, 256))).to(dev), tag)
    check(r["rel"] < 1e-4, f"{tag} clean tube max|dJ|/Jmax < 1e-4")
    check(r["jmin"] < 1e-4 and r["jmax"] < 1e-4, f"{tag} clean tube Jmin and Jmax")
    check(r["med"] > 0.99 and r["frac"] == 1.0, f"{tag} clean tube directions")

    r = k1_compare(torch, "noisy tube", torch.from_numpy(tube((64, 256, 256), noise=40)).to(dev),
                   tag)
    check(r["j8_max"] <= 8 and r["j8_mis"] < 0.01, f"{tag} noisy tube J8 bars")
    check(r["med"] > 0.99 and r["frac"] > 0.95, f"{tag} noisy tube directions")

    # the main path's stack: the J bars of the clean tube, and (make_volume
    # carries Gaussian noise) the J8 and direction bars of the noisy one
    r = k1_compare(torch, "main stack", main_vol, tag)
    check(r["rel"] < 1e-4, f"{tag} main stack max|dJ|/Jmax < 1e-4")
    check(r["jmin"] < 1e-4 and r["jmax"] < 1e-4, f"{tag} main stack Jmin and Jmax")
    check(r["j8_max"] <= 8 and r["j8_mis"] < 0.01, f"{tag} main stack J8 bars")
    check(r["med"] > 0.99 and r["frac"] > 0.95, f"{tag} main stack directions")
    return r["max_abs"]


def phase_k1(torch, card, main_vol):
    from pnr_tpu_torch.ops import frangi_fused
    from pnr_tpu_torch.ops.frangi import frangi3d_plain
    from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused

    for sig in SIGMAS:
        plan = frangi_fused.fused_plan(MAIN_SHAPE, sig, ZDIST)
        print(f"[K1] sigma {sig}: hxy {plan.hxy}, hz {plan.hz}, tile {plan.tile_y} x "
              f"{plan.tile_x}, grid {plan.grid}, rings {plan.ring_g} + {plan.ring_f} planes, "
              f"{plan.smem} bytes of shared memory a block", flush=True)
    n0 = frangi_fused.LAUNCHES
    frangi3d_fused(main_vol, SIGMAS, ZDIST)
    check(frangi_fused.LAUNCHES - n0 == len(SIGMAS) + 1, "K1: one launch per sigma and the decode")
    max_abs = frangi_bars(torch, main_vol, "K1")
    ms = time_ms(torch, lambda: frangi3d_fused(main_vol, SIGMAS, ZDIST))
    plain_ms = time_ms(torch, lambda: frangi3d_plain(main_vol, SIGMAS, ZDIST))
    mvox = main_vol.numel() / 1e6
    print(f"[K1] {MAIN_SHAPE} sigmas {SIGMAS}: kernel {ms:.3f} ms ({mvox / ms * 1e3:.1f} Mvox/s), "
          f"plain {plain_ms:.3f} ms [{card}]", flush=True)
    n = main_vol.numel()
    # u8 in; f32 J and three u8 directions out
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **bound(n * (1 + 4 + 3), frangi_flops(n, SIGMAS, ZDIST))}


def conv_err(k, p):
    return float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)


def phase_k3_k4(torch, card, main_vol):
    """K3 and K4 against their plain versions on the main stack, as f32
    and as u8, with the unfused filter's taps; timed with their plain
    versions and a cuDNN conv3d of the replicate-padded volume."""
    import torch.nn.functional as F

    from pnr_tpu_torch.ops import conv
    from pnr_tpu_torch.ops.gaussian import gaussian_kernel

    torch.backends.cudnn.allow_tf32 = False
    vol_f = main_vol.to(torch.float32)
    n = main_vol.numel()
    s2 = SIGMAS[-1] ** 2
    taps = {"gauss6 (37)": (gaussian_kernel(SIGMAS[-1]), False),
            "z gauss6/2 (19)": (gaussian_kernel(SIGMAS[-1] / ZDIST), False),
            "g1": ((-0.5, 0.0, 0.5), True),
            "g2 (sigma 6)": ((-0.5 * s2, 0.0, 0.5 * s2), True)}
    worst3 = 0.0
    for name, (k, grad) in taps.items():
        for dt, v in (("f32", vol_f), ("u8", main_vol)):
            errs = [conv_err(conv.conv1d_axis(v, k, a, grad), conv.conv1d_axis_plain(v, k, a, grad))
                    for a in (0, 1, 2)]
            kms = [time_ms(torch, lambda a=a: conv.conv1d_axis(v, k, a, grad)) for a in (0, 1, 2)]
            print(f"[K3] {name} {dt}: max|d|/max|plain| along z, y, x "
                  f"{', '.join(f'{e:.3e}' for e in errs)}; kernel ms "
                  f"{', '.join(f'{m:.4f}' for m in kms)} [{card}]", flush=True)
            check(max(errs) < 1e-5, f"K3 {name} {dt}: within 1e-5 of max|plain|")
            worst3 = max(worst3, max(errs))
    # the Hessian's 3-tap difference passes (27 of the unfused path's 30
    # launches) on f32, along each axis
    g1 = (-0.5, 0.0, 0.5)
    ms3 = [time_ms(torch, lambda a=a: conv.conv1d_axis(vol_f, g1, a, True)) for a in (0, 1, 2)]
    print(f"[K3] 3 taps (g1, grad_border), f32 {MAIN_SHAPE}: kernel ms along z, y, x "
          f"{', '.join(f'{m:.4f}' for m in ms3)}; bound {bound(n * 8, n * 6)['bound_ms']:.4f} ms "
          f"[{card}]", flush=True)
    # the timed case: the main path's z Gaussian pass at sigma 6 on f32
    kz = gaussian_kernel(SIGMAS[-1] / ZDIST)
    hz = len(kz) // 2
    wz = torch.from_numpy(kz).to(main_vol.device).view(1, 1, -1, 1, 1)

    def lib3():
        return F.conv3d(F.pad(vol_f[None, None], (0, 0, 0, 0, hz, hz), mode="replicate"), wz)

    lerr = conv_err(lib3()[0, 0], conv.conv1d_axis_plain(vol_f, kz, 0))
    k3 = {"max_abs_err": worst3,
          "ms": time_ms(torch, lambda: conv.conv1d_axis(vol_f, kz, 0)),
          "plain_ms": time_ms(torch, lambda: conv.conv1d_axis_plain(vol_f, kz, 0)),
          "library_ms": time_ms(torch, lib3),
          "ms_3taps_zyx": ms3,
          **bound(n * 8, n * 2 * len(kz))}
    print(f"[K3] z pass, {len(kz)} taps, f32 {MAIN_SHAPE}: kernel {k3['ms']:.4f} ms, plain "
          f"{k3['plain_ms']:.3f} ms, conv3d (pad + conv, TF32 off; max|d|/max|plain| "
          f"{lerr:.3e}) {k3['library_ms']:.3f} ms, bound {k3['bound_ms']:.4f} ms "
          f"({k3['bound_by']}) [{card}]", flush=True)

    k4 = phase_k4(torch, card, main_vol)
    return k3, k4


def k4_digest(out):
    """SHA-256 of a K4 output's float32 bytes (C order)."""
    import hashlib

    return hashlib.sha256(out.contiguous().cpu().numpy().tobytes()).hexdigest()


def phase_k4(torch, card, main_vol):
    """K4 against its plain version on the main stack at each sigma, u8
    and f32; timed at each sigma from u8 beside the K3 y-then-x chain on
    the same input and taps and beside the bound; the sigma-6 u8 output's
    SHA-256 (the paired runs of scripts/torch_filter_kernels.py compare it
    with another checkout's); cuDNN conv3d and the plain version timed at
    sigma 6."""
    import torch.nn.functional as F

    from pnr_tpu_torch.ops import conv
    from pnr_tpu_torch.ops.gaussian import gaussian_kernel

    vol_f = main_vol.to(torch.float32)
    n = main_vol.numel()
    worst4 = 0.0
    per_sigma = {}
    for sig in SIGMAS:
        kxy = gaussian_kernel(sig)
        for dt, v in (("u8", main_vol), ("f32", vol_f)):
            plan = conv.conv_yx_plan(MAIN_SHAPE, len(kxy), len(kxy), dt == "u8")
            e = conv_err(conv.conv_yx(v, kxy, kxy), conv.conv_yx_plain(v, kxy, kxy))
            print(f"[K4] sigma {sig:g} ({len(kxy)} + {len(kxy)} taps) {dt}: max|d|/max|plain| "
                  f"{e:.3e}; tile {plan.ty} x {plan.tx}, grid {plan.grid}, {plan.smem} bytes of "
                  f"shared memory a block", flush=True)
            check(e < 1e-5, f"K4 sigma {sig:g} {dt}: within 1e-5 of max|plain|")
            worst4 = max(worst4, e)
        fns = (lambda: conv.conv_yx(main_vol, kxy, kxy),
               lambda: conv.conv1d_axis(conv.conv1d_axis(main_vol, kxy, 1), kxy, 2))
        # per call in runs of 20 back-to-back calls (the host ahead of the
        # card, as in the filter), and alone (the host's call included)
        ms, pair_ms = time_turns_ms(torch, fns, reps=11, calls=20, warmup=2)
        single_ms, pair_single_ms = time_turns_ms(torch, fns, reps=11, warmup=2)
        b = bound(n * (1 + 4), n * 2 * 2 * len(kxy))
        per_sigma[f"{sig:g}"] = {"ms": ms, "k3_pair_ms": pair_ms, "single_ms": single_ms,
                                 "k3_pair_single_ms": pair_single_ms, **b}
        print(f"[K4] sigma {sig:g}, u8 {MAIN_SHAPE}, in turns: kernel {ms:.4f} ms per call back "
              f"to back, {single_ms:.4f} alone; K3 along y then K3 along x {pair_ms:.4f}, "
              f"{pair_single_ms:.4f}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]",
              flush=True)
    kxy = gaussian_kernel(SIGMAS[-1])
    digest = k4_digest(conv.conv_yx(main_vol, kxy, kxy))
    check(digest == k4_digest(conv.conv_yx(main_vol, kxy, kxy)), "K4 is deterministic")
    print(f"[K4] sigma {SIGMAS[-1]:g} u8 {MAIN_SHAPE} output sha256 {digest}", flush=True)
    h = len(kxy) // 2
    w2 = torch.from_numpy(np.outer(kxy, kxy).astype(np.float32)).to(main_vol.device)[None, None, None]

    def lib4():
        return F.conv3d(F.pad(vol_f[None, None], (h, h, h, h, 0, 0), mode="replicate"), w2)

    lerr = conv_err(lib4()[0, 0], conv.conv_yx_plain(main_vol, kxy, kxy))
    six = per_sigma[f"{SIGMAS[-1]:g}"]
    k4 = {"max_abs_err": worst4, "ms": six["ms"], "single_ms": six["single_ms"],
          "plain_ms": time_ms(torch, lambda: conv.conv_yx_plain(main_vol, kxy, kxy)),
          "library_ms": time_ms(torch, lib4), "bound_ms": six["bound_ms"],
          "bound_by": six["bound_by"], "per_sigma": per_sigma, "sha256_sigma6_u8": digest}
    print(f"[K4] sigma {SIGMAS[-1]:g}, u8 {MAIN_SHAPE}: kernel {k4['ms']:.4f} ms back to back, plain {k4['plain_ms']:.3f} ms, "
          f"conv3d of the f32 stack ({len(kxy)}x{len(kxy)} outer-product weight, TF32 off; "
          f"max|d|/max|plain| {lerr:.3e}) {k4['library_ms']:.3f} ms, bound {k4['bound_ms']:.4f} ms "
          f"({k4['bound_by']}) [{card}]", flush=True)
    return k4


def peak_bytes_per_voxel(torch, fn, n):
    """Peak device bytes per voxel that `fn` allocates above what is
    resident when it starts."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / n


def phase_unfused(torch, card, main_vol):
    """The unfused filter on the card against the plain chain at K1's bars,
    timed next to K1; each route's peak memory; the tiled engines bitwise
    the monolithic filter on the main stack."""
    from pnr_tpu_torch.ops.frangi import frangi3d, normalize_to_u8
    from pnr_tpu_torch.ops.frangi_blocked import frangi3d_blocked, frangi3d_tiled, pick_blocks
    from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused

    frangi_bars(torch, main_vol, "unfused")
    ms = time_ms(torch, lambda: frangi3d(main_vol, SIGMAS, ZDIST))
    k1_ms = time_ms(torch, lambda: frangi3d_fused(main_vol, SIGMAS, ZDIST))
    print(f"[unfused] {MAIN_SHAPE} sigmas {SIGMAS}: frangi3d (K4, K3) {ms:.3f} ms, K1 {k1_ms:.3f} ms "
          f"[{card}]", flush=True)
    n = main_vol.numel()
    blocks = pick_blocks(MAIN_SHAPE, SIGMAS, ZDIST)
    def k1_stage():
        # the filter stage as the pipeline runs it: K1, then J8 from J
        j, jmin, jmax, *dirs = frangi3d_fused(main_vol, SIGMAS, ZDIST)
        return normalize_to_u8(j, jmin, jmax), dirs

    peaks = {
        "K1": peak_bytes_per_voxel(torch, lambda: frangi3d_fused(main_vol, SIGMAS, ZDIST), n),
        "K1 + normalize_to_u8": peak_bytes_per_voxel(torch, k1_stage, n),
        "unfused": peak_bytes_per_voxel(torch, lambda: frangi3d(main_vol, SIGMAS, ZDIST), n),
        f"tiled {blocks}": peak_bytes_per_voxel(
            torch, lambda: frangi3d_tiled(main_vol, SIGMAS, ZDIST, block_z=blocks[0],
                                          block_y=blocks[1]), n),
    }
    print(f"[unfused] peak device bytes per voxel above the resident u8 stack: "
          f"{json.dumps({k: round(v, 3) for k, v in peaks.items()})} [{card}]", flush=True)

    mono = frangi3d(main_vol, SIGMAS, ZDIST)
    for label, fn in (
        ("tiled (32, 160)", lambda: frangi3d_tiled(main_vol, SIGMAS, ZDIST, block_z=32, block_y=160)),
        ("tiled (48, 200)", lambda: frangi3d_tiled(main_vol, SIGMAS, ZDIST, block_z=48, block_y=200)),
        ("blocked 32", lambda: frangi3d_blocked(main_vol, SIGMAS, ZDIST, block_z=32)),
    ):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        same = [bool(torch.equal(got[i], mono[i])) for i in (0, 3, 4, 5)]
        jmin_eq = float(got[1]) == float(mono[1])
        jmax_rel = abs(float(got[2]) - float(mono[2])) / max(abs(float(mono[2])), 1e-30)
        print(f"[tiled] {label}: J, Vx, Vy, Vz bitwise {same}, Jmin bitwise {jmin_eq}, Jmax rel "
              f"{jmax_rel:.3e}; {dt * 1e3:.3f} ms [{card}]", flush=True)
        check(all(same) and jmin_eq and jmax_rel <= 1e-6,
              f"{label}: bitwise the monolithic frangi3d (Jmax within rtol 1e-6)")
    return {"unfused_ms": ms, "k1_ms": k1_ms, "peaks": peaks}


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


def k2_sample_grid(torch, eng, vol, corner, qs):
    """grid_sample's yardstick for K2 (sampling only: no sums, no
    correlation): the global coordinates (corner + clamped patch-frame
    coordinate) of every template sample of the queries `qs`, as
    grid_sample's normalised (1, 1, 1, N, 3) xyz grid, and the sigma
    blocks' sizes (T, B, K_s)."""
    from pnr_tpu_torch.ops import zncc_exact as ze

    tab, cnt = eng.tables.tab, eng.tables.cnt.tolist()
    cf = corner.to(torch.float32)[:, None, None, :]  # (T, 1, 1, 3) zyx
    grids, shapes = [], []
    for si, k in enumerate(cnt):
        tv, tu, tw, _ = tab[si, :k].unbind(-1)
        rz, ry, rx = ze.sample_coords(qs[..., None], tv, tu, tw)
        zyx = torch.stack([rz, ry, rx], -1) + cf
        grids.append(torch.stack([zyx[..., 2 - i] / max(vol.shape[2 - i] - 1, 1) * 2.0 - 1.0
                                  for i in range(3)], -1).reshape(-1, 3))
        shapes.append(tuple(rz.shape))
    return torch.cat(grids).reshape(1, 1, 1, -1, 3), shapes


def phase_k2(torch, card, main_vol):
    """K2 against its plain version on four sets of queries (bitwise
    deterministic over two launches); timed at the tracer's and the
    estimate's shapes, with a grid_sample yardstick at the same samples."""
    import torch.nn.functional as F

    from pnr_tpu_torch.ops import zncc_exact as ze
    from pnr_tpu_torch.ops.zncc_exact import (
        ExactPatchEngine, ZnccTemplates, exact_corr_from_sums, exact_sums, exact_sums_plain,
    )

    dev = torch.device(DEVICE)
    eng = ExactPatchEngine(ZnccTemplates(SIGMAS, False), 2, dev)
    rng = np.random.default_rng(11)
    tube_vol = torch.from_numpy(tube((64, 256, 256), noise=40)).to(dev)
    worst = 0.0
    row = {}
    # (volume, T, B, spread of the centres about the axis in z)
    cases = (("tube", tube_vol, 256, 20, 1.0), ("tube", tube_vol, 512, 1, 1.0),
             ("main stack", main_vol, 128, 20, 1.0), ("main stack", main_vol, 173, 1, 0.5),
             ("main stack", main_vol, 128, 1, 1.0))
    for label, vol, t, b, axis_sd in cases:
        pos, d = k2_queries(rng, tuple(vol.shape), t, b, axis_sd)
        p = torch.from_numpy(pos).to(dev)
        dd = torch.from_numpy(d).to(dev)
        corner = eng.corners(vol.shape, p.mean(dim=1))
        qs = eng.qinfo(vol, corner, p, dd)
        dims = eng.dims(vol.shape)
        plan = ze.kernel_plan(dims, b, eng.tables.tab.shape[0])
        smem = ze.smem_bytes(plan, dims[1], b, eng.tables.tab.shape[0])

        def kern():
            return exact_sums(vol, corner, qs, eng.tables, dims)

        sk = kern()
        same = bool(torch.equal(sk, kern()))
        sp = exact_sums_plain(vol, corner, qs, eng.tables, dims)
        col_err = [float((sk[..., i] - sp[..., i]).abs().max()) /
                   max(float(sp[..., i].abs().max()), 1.0) for i in range(3)]
        ck, sgk = exact_corr_from_sums(eng.tables, sk)
        cp, sgp = exact_corr_from_sums(eng.tables, sp)
        cerr = float((ck - cp).abs().max())
        agree = float((sgk == sgp).float().mean())
        worst = max(worst, cerr)
        # per call in runs of 20 back-to-back calls, as the tracer makes them
        ms = time_turns_ms(torch, (kern,), calls=20)[0]
        print(f"[K2] {label} {tuple(vol.shape)} T={t} B={b} patch {dims}: {plan.nz} slabs of "
              f"{plan.step} floors a trace, {smem} bytes of shared memory a block; sums "
              f"max|d|/max|plain| per column {', '.join(f'{e:.3e}' for e in col_err)}; corr "
              f"max|d| {cerr:.3e}; sigma agreement {agree:.4f}; two launches bitwise equal "
              f"{same}; {ms:.4f} ms per call [{card}]", flush=True)
        check(max(col_err) < 1e-5, f"K2 {label} T={t} B={b}: sums within 1e-5 of each column's scale")
        check(cerr < 3e-4 and agree > 0.97,
              f"K2 {label} T={t} B={b}: corr atol 3e-4 and sigma agreement > 97%")
        check(same, f"K2 {label} T={t} B={b}: two launches bitwise equal")
        if label == "main stack" and t == 128:
            row[f"main_t128_b{b}_ms"] = ms
        if row.get("ms") is None:
            # the timed case, T=256, B=20 on the tube volume: the u8
            # windows the queries need (at most the volume), the query rows,
            # the templates and the sums; K2_SAMPLE_FLOPS per template sample
            nbytes = (min(t * dims[0] * dims[1] * dims[2], vol.numel()) + qs.numel() * 4
                      + corner.numel() * 4 + eng.tables.tab.numel() * 4 + sk.numel() * 4)
            samples = t * b * int(eng.tables.cnt.sum())
            grid, shapes = k2_sample_grid(torch, eng, vol, corner, qs)
            vol_f = vol.to(torch.float32)[None, None]

            def lib():
                return F.grid_sample(vol_f, grid, mode="bilinear", padding_mode="border",
                                     align_corners=True)

            # its samples summed per (trace, query, sigma) against K2's A column
            vals = lib().reshape(-1)
            a_lib, beg = [], 0
            for shp in shapes:
                n = shp[0] * shp[1] * shp[2]
                a_lib.append((vals[beg:beg + n].view(shp) - qs[..., ze._Q_M0, None]).sum(-1))
                beg += n
            lerr = float((torch.stack(a_lib, -1) - sk[..., 0]).abs().max()) / max(
                float(sk[..., 0].abs().max()), 1.0)
            print(f"[K2] grid_sample (sampling only) at the {samples} samples' coordinates: its "
                  f"samples summed per query against K2's A, max|d|/max|A| {lerr:.3e}", flush=True)
            check(lerr < 1e-3, "K2's grid_sample yardstick samples where K2 samples")
            ms_lib = time_turns_ms(torch, (kern, lib), reps=11)
            row.update({"ms": ms, "single_ms": ms_lib[0], "library_ms": ms_lib[1],
                        "library_call": "grid_sample at the samples' coordinates (sampling only)",
                        "plain_ms": time_ms(torch, lambda: exact_sums_plain(vol, corner, qs,
                                                                            eng.tables, dims)),
                        "slabs": plan.nz, "smem_bytes": smem, "samples": samples,
                        **bound(nbytes, samples * K2_SAMPLE_FLOPS)})
            del grid, vals, a_lib
    print(f"[K2] tube T=256 B=20 sigmas {SIGMAS}: kernel {row['ms']:.4f} ms per call back to "
          f"back, {row['single_ms']:.4f} alone; grid_sample (sampling only) {row['library_ms']:.4f}"
          f"; plain {row['plain_ms']:.3f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"main stack T=128 B=20 {row['main_t128_b20_ms']:.4f} ms, B=1 "
          f"{row['main_t128_b1_ms']:.4f} ms [{card}]", flush=True)
    return {"max_abs_err": worst, "deterministic": True, **row}


def tube_queries(rng, shape, t, b, axis_sd, anywhere=0.25):
    """k2_queries with a chosen share of the clouds anywhere in the volume."""
    pos, d = k2_queries(rng, shape, t, b, axis_sd)
    l, h, w = shape
    move = rng.random(t) < anywhere
    shift = np.stack([rng.uniform(0, w - 1, t), rng.uniform(0, h - 1, t),
                      rng.uniform(0, l - 1, t)], -1) - pos.mean(axis=1)
    pos[move] += shift[move][:, None, :].astype(np.float32)
    return pos, d


def hat_touched_bytes(torch, rel, origin, pdims, zpitch, ypitch, elem=4):
    """Distinct field bytes that tube_corr's line samples read: per row
    (rz, ry, rx, _) the two z (one in a one-plane window) and two y taps'
    runs of six elements (two x taps, three channels) from the row's
    window origin `origin` (element offsets, one per row), with the
    kernel's tap clamping."""
    r = rel.reshape(-1, 4)
    taps = [torch.clamp(torch.floor(r[:, i]).long(), 0, max(pdims[i] - 2, 0)) for i in range(3)]
    start = origin.reshape(-1) + taps[0] * zpitch + taps[1] * ypitch + 3 * taps[2]
    dev = rel.device
    offs = (torch.arange(2 if pdims[0] > 1 else 1, device=dev)[:, None, None] * zpitch
            + torch.arange(2, device=dev)[None, :, None] * ypitch
            + torch.arange(6, device=dev)[None, None, :]).reshape(-1)
    return int(torch.unique(start[:, None] + offs[None, :]).numel()) * elem


def col_errs(k, p):
    """max|k - p| / max(|p|, 1) per channel of (..., >=3) samples."""
    return [float((k[..., c] - p[..., c]).abs().max()) / max(float(p[..., c].abs().max()), 1.0)
            for c in range(3)]


def phase_maps(torch, card, main_vol):
    """The tube map build through K3 against the plain shift-and-add, on
    the main path's stack; returns the kernel's field."""
    from pnr_tpu_torch.ops import gaussian
    from pnr_tpu_torch.ops.zncc_fast import (
        TubeZnccModel, build_tube_maps_packed, build_tube_maps_packed_plain,
    )

    model = TubeZnccModel(SIGMAS, False)
    n0 = gaussian.LAUNCHES
    field = build_tube_maps_packed(main_vol, model)
    launches = gaussian.LAUNCHES - n0
    plain = build_tube_maps_packed_plain(main_vol, model)
    s, z, y, x3 = field.shape
    errs = col_errs(field.view(s, z, y, x3 // 3, 3), plain.view(s, z, y, x3 // 3, 3))
    del plain
    print(f"[maps] {MAIN_SHAPE} sigmas {SIGMAS}: field {tuple(field.shape)} "
          f"{field.numel() * 4 / 1e9:.3f} GB, {launches} K3 launches; max|d|/max(|plain|,1) "
          f"per channel {', '.join(f'{e:.3e}' for e in errs)}", flush=True)
    check(max(errs) < 1e-5, "map build: per channel max|d| / max(|plain|, 1) < 1e-5")
    ms = time_ms(torch, lambda: build_tube_maps_packed(main_vol, model))
    plain_ms = time_ms(torch, lambda: build_tube_maps_packed_plain(main_vol, model))
    print(f"[maps] build: kernel route {ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]", flush=True)
    return field, {"max_rel_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def corr_check(label, a, b):
    """corr max|d| < 1e-4 and sigma agreement > 0.99 between two (corr, sig)."""
    cerr = float((a[0] - b[0]).abs().max())
    agree = float((a[1] == b[1]).float().mean())
    print(f"[{label}] corr max|d| {cerr:.3e}, sigma agreement {agree:.4f}", flush=True)
    check(cerr < 1e-4 and agree > 0.99, f"{label}: corr max|d| < 1e-4, sigma agreement > 0.99")
    return cerr


def tube_corr_compare(torch, eng, field, label, pos, d, single):
    """tube_corr against its plain chain on one evaluation: the line sums
    within 1e-5 of each column's scale, then corr_check; returns the
    window layout, the corners and the corr error."""
    from pnr_tpu_torch.ops import tube_corr as tc

    corners = eng.window(field, pos.mean(dim=1), single)
    lay = eng.layout(field, single)
    out, ksums = tc.tube_corr(field, lay.groups, corners, pos, d, eng.tables, lay.params,
                              scoring=single, with_sums=True)
    kc, ks = out
    pc, ps, psums = tc.tube_corr_plain(field, lay.groups, corners, pos, d, eng.tables)
    errs = col_errs(ksums, psums)
    print(f"[{label}] windows {[g[2] for g in lay.groups]}: line sums max|d|/max(|plain|,1) "
          f"{', '.join(f'{e:.3e}' for e in errs)}", flush=True)
    check(max(errs) < 1e-5, f"{label}: line sums within 1e-5 of each column's scale")
    return lay, corners, corr_check(label, (kc, ks), (pc, ps))


def profiler_warmup(torch, n=32):
    """torch.profiler drops the first device events of a session (it has
    missed K1's and K4's first launches of a profiled run): absorb them
    with n short spin kernels (`spin_kernel`, left out of every count)
    before the work it measures."""
    for _ in range(n):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def device_ms_per_launch(torch, fn, reps=20, kernel="tube_corr_kernel"):
    """torch.profiler's device time per launch of the kernel whose name
    holds `kernel`, over `reps` calls of `fn` (the profiler may drop a
    run's first events: the mean is over the launches it saw)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_warmup(torch)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hit = [e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name]
    check(hit, f"the profiler saw {kernel}")
    return sum(e.time_range.elapsed_us() for e in hit) / len(hit) / 1e3, len(hit)


def tube_corr_yardstick(torch, eng, field, lay, corners, pos, d):
    """One grid_sample call (5-D, trilinear, align_corners, border) on the
    float32 field at the global coordinates (corner + window coordinate)
    of every line sample of the evaluation, one batch entry per sigma,
    checked against the plain samples; with the field bytes those samples
    touch and the real line samples (vmask = 1) they stand for."""
    import torch.nn.functional as F

    from pnr_tpu_torch.ops import tube_corr as tc

    s_, z_, y_, x3_ = field.shape
    dims = (z_, y_, x3_ // 3)
    t = pos.shape[0]
    glob, want, touched = [], [], 0
    for g, (g0, g1, pdims) in enumerate(lay.groups):
        corner = corners[:, g]
        rel = tc.rel_coords(eng.tables, dims, pdims, corner, pos, d, g0, g1)  # (T, gs, M, 4)
        gs, m = g1 - g0, rel.shape[2]
        glob.append(rel[..., :3] + corner.view(t, 1, 1, 3).to(torch.float32))
        want.append(tc.hat_sample_field_plain(field[g0:g1], corner, rel.reshape(t, gs * m, 4),
                                              pdims).view(t, gs, m, 4)[..., :3])
        sig = torch.arange(g0, g1, device=field.device).repeat_interleave(m)
        origin = (((sig[None, :] * z_ + corner[:, :1].long()) * y_ + corner[:, 1:2].long()) * x3_
                  + 3 * corner[:, 2:].long())
        touched += hat_touched_bytes(torch, rel, origin, pdims, y_ * x3_, x3_,
                                     field.element_size())
    glob = torch.cat(glob, 1).permute(1, 0, 2, 3)  # (S, T, M, 3) zyx
    want = torch.cat(want, 1).permute(1, 0, 2, 3).reshape(s_, -1, 3)
    grid = torch.stack([glob[..., 2 - i] / max(dims[2 - i] - 1, 1) * 2.0 - 1.0
                        for i in range(3)], -1)
    grid = grid.reshape(s_, 1, 1, -1, 3)
    fin = field.view(s_, z_, y_, x3_ // 3, 3).permute(0, 4, 1, 2, 3)

    def lib():
        return F.grid_sample(fin, grid, mode="bilinear", padding_mode="border", align_corners=True)

    lerr = max(col_errs(lib().view(s_, 3, -1).transpose(1, 2), want))
    real = pos.shape[0] * pos.shape[1] * int(eng.tables.vmask.sum())
    return lib, lerr, touched, real


def tube_corr_row(torch, card, eng, field, label, lay, corners, pos, d, single):
    """Time one evaluation: the kernel and the grid_sample yardstick in
    turns (CUDA events, so the wrapper's host cost is included: per call
    back to back, and alone), the kernel's device time per launch
    (torch.profiler), the plain chain; the bound from the bytes and FLOPs
    it needs."""
    from pnr_tpu_torch.ops import tube_corr as tc

    lib, lerr, touched, real = tube_corr_yardstick(torch, eng, field, lay, corners, pos, d)
    print(f"[{label}] grid_sample on the field at the same rows: max|d|/max(|plain|,1) "
          f"{lerr:.3e}", flush=True)
    check(lerr < 1e-3, f"{label}: grid_sample samples the field as the plain chain does")

    def kern():
        return tc.tube_corr(field, lay.groups, corners, pos, d, eng.tables, lay.params,
                            scoring=single)

    t, n = pos.shape[:2]
    # the field bytes the samples touch, pos and dirs in, the corners, corr and sig out
    nbytes = touched + 2 * pos.numel() * 4 + corners.numel() * 4 + 2 * t * n * 4
    one_plane = all(pdims[0] == 1 for _, _, pdims in lay.groups)
    flops = (real * (HAT_ROW_PLANE_FLOPS if one_plane else HAT_ROW_FLOPS)
             + t * n * eng.s_count * ZNCC_FLOPS)
    # per call in runs of 20 back-to-back calls, as the tracer makes them
    # between its other small launches; and one call alone after a sync
    ms, library_ms = time_turns_ms(torch, (kern, lib), calls=20)
    single_ms, library_single_ms = time_turns_ms(torch, (kern, lib), reps=51)
    # inside a CUDA graph of 20 calls, as the tracer's stage graphs launch it
    graph_ms, library_graph_ms = graph_turns_ms(torch, (kern, lib))
    dev_ms, seen = device_ms_per_launch(torch, kern)
    row = {"ms": ms,
           "plain_ms": time_ms(torch, lambda: tc.tube_corr_plain(field, lay.groups, corners, pos, d,
                                                                   eng.tables)),
           "library_ms": library_ms, "device_ms": dev_ms, "single_ms": single_ms,
           "library_single_ms": library_single_ms, "graph_ms": graph_ms,
           "library_graph_ms": library_graph_ms, **bound(nbytes, flops)}
    print(f"[{label}] T={t} N={n}: kernel {ms:.4f} ms per call back to back, {single_ms:.4f} ms "
          f"alone, {graph_ms:.4f} ms in a graph of 20 calls (device {dev_ms:.4f} ms per launch, "
          f"{seen} launches profiled); grid_sample {library_ms:.4f} ms back to back, "
          f"{library_single_ms:.4f} ms alone, {library_graph_ms:.4f} ms in a graph of 20 calls; "
          f"plain {row['plain_ms']:.3f} ms; bound {row['bound_ms']:.5f} ms ({row['bound_by']}: "
          f"{nbytes} B, {flops} FLOP) [{card}]", flush=True)
    return row


def phase_tube_corr(torch, card, field):
    """tube_corr against its plain chain on the main stack's field: the
    tracer's evaluation (K5's row) and seed scoring (K6's row)."""
    from pnr_tpu_torch.ops.zncc_fast import TubePatchEngine, TubeZnccModel

    dev = field.device
    eng = TubePatchEngine(TubeZnccModel(SIGMAS, False), 2, ZDIST, device=dev)
    dims = eng.vol_dims(field.shape)
    rng = np.random.default_rng(12)

    # K5's row: one tracer chunk, T=128 traces of N=20 particles
    pos, d = (torch.from_numpy(a).to(dev) for a in tube_queries(rng, dims, 128, 20, 1.0))
    lay, corners, err5 = tube_corr_compare(torch, eng, field, "tube_corr tracer", pos, d, False)
    k5 = {"max_abs_err": err5,
          **tube_corr_row(torch, card, eng, field, "tube_corr tracer", lay, corners, pos, d, False)}

    # K6's row: B=1 seed scoring in one sigma_max window, along the axis
    # and anywhere; the last set is the timed one
    worst6, k6 = 0.0, None
    for label, t, axis_sd, anywhere in (("173 seeds on the axis", 173, 0.5, 0.0),
                                        ("T=512 anywhere", 512, 1.0, 1.0)):
        pos, d = (torch.from_numpy(a).to(dev)
                  for a in tube_queries(rng, dims, t, 1, axis_sd, anywhere))
        lay, corners, err = tube_corr_compare(torch, eng, field, f"tube_corr scoring, {label}",
                                              pos, d, True)
        worst6 = max(worst6, err)
        corr_check(f"tube_corr scoring, {label}: sigma_max window vs group windows",
                   eng.eval_fused(field, pos, d),
                   eng.likelihood(field, eng.window(field, pos[:, 0]), pos, d))
        k6 = tube_corr_row(torch, card, eng, field, f"tube_corr scoring, {label}", lay, corners,
                           pos, d, True)
    return k5, {"max_abs_err": worst6, **k6}


def host_ms(fn, reps=21):
    """Median host milliseconds of fn() over `reps` calls after one."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


#: the draws' shapes on the main path: (label, iterations, draws a trace)
THREEFRY_SHAPES = (("exact stage", 8, 20), ("tube stage", 16, 20), ("trace_init", 1, 1))


def phase_threefry(torch, card):
    """[threefry]: the tracer's draws' kernel (csrc/threefry.cu) against its
    plain version on the same card tensors at the main path's shapes (a
    chunk of T = 128 traces at np 20: 8 iterations a stage in exact mode,
    16 in tube mode; `trace_init`'s one iteration of one draw), at it0 1 and
    2**30 + 3 (steps past 2**31): bitwise, and bitwise the host draws at
    it0 1. Each shape timed: the kernel in turns with the plain version
    (CUDA events, per call in runs of 20 back to back, and alone), beside
    the host draws a stage made before (`stage_uniforms` on the host, and
    with the copies of its two arrays to the card) and the bound."""
    from pnr_tpu_torch.hostpath import threefry as tf
    from pnr_tpu_torch.ops import threefry
    from pnr_tpu_torch.smc.tracker import trace_keys

    dev = torch.device(DEVICE)
    t = 128
    raw = trace_keys(tf.key_from_seed(0), np.arange(t))
    keys = threefry.key_tensor(raw, dev)
    out = {}
    for label, n_it, npart in THREEFRY_SHAPES:
        err = 0.0
        for it0 in ((0,) if n_it == 1 else (1, 2**30 + 3)):
            it = torch.tensor(it0, dtype=torch.int32, device=dev)
            u1, ru = threefry.stage_draws(keys, it, n_it, npart)
            pu1, pru = threefry.stage_draws_plain(keys, it, n_it, npart)
            err = max(err, float((u1 - pu1).abs().max()), float((ru - pru).abs().max()))
            check(torch.equal(u1, pu1) and torch.equal(ru, pru),
                  f"[threefry] {label} at it0 {it0}: bitwise the plain version")
            if it0 < 2:
                hu1, hru = tf.stage_uniforms(raw, it0, n_it, npart)
                check(np.array_equal(u1.cpu().numpy(), hu1) and np.array_equal(ru.cpu().numpy(), hru),
                      f"[threefry] {label}: bitwise the host draws")
        it = torch.tensor(0 if n_it == 1 else 1, dtype=torch.int32, device=dev)
        it0 = int(it)

        def kern():
            threefry.stage_draws(keys, it, n_it, npart)

        def plain():
            threefry.stage_draws_plain(keys, it, n_it, npart)

        ms, plain_ms = time_turns_ms(torch, [kern, plain], calls=20)
        alone_ms, plain_alone_ms = time_turns_ms(torch, [kern, plain])

        def host_copy():
            for a in tf.stage_uniforms(raw, it0, n_it, npart):
                torch.from_numpy(a).to(dev)
            torch.cuda.synchronize()

        host = host_ms(lambda: tf.stage_uniforms(raw, it0, n_it, npart))
        host_to_card = host_ms(host_copy)
        draws = n_it * t * (npart + 1)
        int_ops, flops = threefry_ops(n_it, t, npart)
        row = {"max_abs_err": err, "ms": ms, "alone_ms": alone_ms, "plain_ms": plain_ms,
               "plain_alone_ms": plain_alone_ms, "host_draw_ms": host,
               "host_draw_and_copy_ms": host_to_card,
               **bound(t * 8 + 4 + 4 * draws, flops, int_ops),
               "library_ms": None, "shape": {"T": t, "n_it": n_it, "np": npart}}
        print(f"[threefry] {label} (T={t}, {n_it} iterations, {npart} draws a trace): bitwise the "
              f"plain version (max|d| {err}); kernel {ms:.4f} ms back to back, {alone_ms:.4f} "
              f"alone; plain {plain_ms:.4f}, {plain_alone_ms:.4f}; the host draws "
              f"(`stage_uniforms`) {host:.4f} ms, with the copies to the card "
              f"{host_to_card:.4f}; bound {row['bound_ms']:.6f} ms ({row['bound_by']}); no "
              f"library call draws jax.random's Threefry [{card}]", flush=True)
        out[label] = row
    return out


def phase_bf16(torch):
    """A forced bfloat16 field: tube_corr against its plain chain on it,
    and the field against the float32 one through the tracer's engine."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    dev = torch.device(DEVICE)
    shape = (64, 256, 256)
    vol = torch.from_numpy(tube(shape, noise=40)).to(dev)
    rng = np.random.default_rng(13)
    pos, d = (torch.from_numpy(a).to(dev) for a in tube_queries(rng, shape, 512, 1, 1.0))
    chunk = [torch.from_numpy(a).to(dev) for a in tube_queries(rng, shape, 128, 20, 1.0)]
    out = {}
    for dt in ("f32", "bf16"):
        cfg = PNRConfig(sigmas=SIGMAS, znccth=0.5, kappa=3.0, step=2, ni=8, np=20, zdist=ZDIST,
                        nodepervol=4, vol=9, zncc_mode="tube", tube_map_dtype=dt)
        tracker = BatchedTracker(cfg, dev)
        field = tracker.prepare_field(vol)
        check(field.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32), "field dtype")
        if dt == "bf16":
            # the tracer's windows, and scoring's (the group windows on bf16)
            tube_corr_compare(torch, tracker.engine, field, "bf16 tube_corr tracer", *chunk, False)
            tube_corr_compare(torch, tracker.engine, field, "bf16 tube_corr scoring", pos, d, False)
        out[dt] = tracker.engine.eval_fused(field, pos, d)
    err = float((out["bf16"][0] - out["f32"][0]).abs().max())
    flipped = out["bf16"][1] != out["f32"][1]
    flips = float(flipped.float().mean())
    at = float(out["f32"][0][flipped].abs().max()) if bool(flipped.any()) else 0.0
    print(f"[bf16] {shape} noisy tube, T=512 B=1: corr max|d| {err:.3e}, sigma flips {flips:.4f} "
          f"(largest |corr| at a flip {at:.4f})", flush=True)
    check(err < 8e-3 and flips < 0.03, "bf16 field: corr max error < 8e-3, sigma flips < 3%")


def cli_argv(src, workdir, tag, mode, params=MAIN_PARAMS):
    return ["-i", src, "-p", *params, "--device", DEVICE, "--zncc-mode", mode,
            "-o", os.path.join(workdir, f"{tag}.swc"),
            "--metrics", os.path.join(workdir, f"{tag}.json"), "--quiet"]


def counters():
    """Every kernel launch counter of the port, by name."""
    from pnr_tpu_torch.ops import conv, cuda, frangi_fused, gaussian, threefry, tube_corr
    from pnr_tpu_torch.ops import zncc_exact
    from pnr_tpu_torch.smc import graphs

    return {
        "frangi3d_fused": (frangi_fused, "LAUNCHES"),
        "exact_sums": (zncc_exact, "LAUNCHES"),
        "conv1d_axis": (conv, "CONV1D_LAUNCHES"),
        "conv_yx": (conv, "CONV_YX_LAUNCHES"),
        "conv1d_along_axis": (gaussian, "LAUNCHES"),
        "tube_corr_trace": (tube_corr, "TRACE_LAUNCHES"),
        "tube_corr_score": (tube_corr, "SCORE_LAUNCHES"),
        "self_check": (cuda, "PROBE_LAUNCHES"),
        # the tracer's draws: one a stage and one a trace_init
        "threefry": (threefry, "LAUNCHES"),
        # the tracer's stage graphs (smc/graphs.py): each replay has added
        # its stage's K2 or tube_corr launches to their counters above
        "graph_replays": (graphs, "REPLAYS"),
        "graph_captures": (graphs, "CAPTURES"),
    }


def reset_counters():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counters():
    return {k: getattr(mod, attr) for k, (mod, attr) in counters().items()}


#: the kernels each path must launch
PATH_KERNELS = {
    "exact": ("frangi3d_fused", "exact_sums", "threefry"),
    "tube": ("frangi3d_fused", "conv1d_along_axis", "tube_corr_trace", "tube_corr_score",
             "threefry"),
    "unfused": ("conv1d_axis", "conv_yx", "exact_sums", "threefry"),
    # the soma stage's xy Gaussian on K3, then the exact path
    "soma": ("conv1d_axis", "frangi3d_fused", "exact_sums", "threefry"),
    # the 2-D filter's Gaussians on K3; the 2-D map build on K3
    "2d exact": ("conv1d_axis", "exact_sums", "threefry"),
    "2d tube": ("conv1d_axis", "conv1d_along_axis", "tube_corr_trace", "tube_corr_score",
                "threefry"),
}


def counting_seed_scoring():
    """Wrap the pipelines' seed scoring (the single stack's and the sharded
    one's) so that it counts the K2 and tube_corr launches made inside it,
    on its own thread (the warm thread launches the tracer's kernels
    meanwhile); returns the counts and an undo."""
    from pnr_tpu_torch.ops import tube_corr, zncc_exact
    from pnr_tpu_torch.pipeline import reconstruct, sharded_reconstruct

    score = reconstruct._score_seeds
    score_sharded = sharded_reconstruct.score_seeds_sharded
    kernels = {"exact_sums": (zncc_exact, "_exact_sums_cuda"),
               "tube_corr": (tube_corr, "_tube_corr_cuda")}
    real = {k: getattr(mod, name) for k, (mod, name) in kernels.items()}
    counts = {k: 0 for k in kernels}
    scoring = threading.local()

    def scored(fn):
        def counted(*a, **k):
            scoring.on = True
            try:
                return fn(*a, **k)
            finally:
                scoring.on = False
        return counted

    def launch(name):
        def wrapped(*a, **k):
            out = real[name](*a, **k)
            if getattr(scoring, "on", False):
                counts[name] += 1
            return out
        return wrapped

    reconstruct._score_seeds = scored(score)
    sharded_reconstruct.score_seeds_sharded = scored(score_sharded)
    for k, (mod, name) in kernels.items():
        setattr(mod, name, launch(k))

    def undo():
        reconstruct._score_seeds = score
        sharded_reconstruct.score_seeds_sharded = score_sharded
        for k, (mod, name) in kernels.items():
            setattr(mod, name, real[k])

    return counts, undo


def counting_stages():
    """Count the tracer's stages (eager `BatchedTracker.trace_stage` calls
    and the stage-graph runner's `stage` calls); returns the count and an
    undo."""
    from pnr_tpu_torch.smc import graphs
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    counts = {"stages": 0}
    real = (BatchedTracker.trace_stage, graphs.StageGraphs.stage)

    def counted(fn):
        def wrapped(*a, **k):
            counts["stages"] += 1
            return fn(*a, **k)
        return wrapped

    BatchedTracker.trace_stage, graphs.StageGraphs.stage = (counted(f) for f in real)

    def undo():
        BatchedTracker.trace_stage, graphs.StageGraphs.stage = real

    return counts, undo


def phase_main(torch, card, src, workdir, mode, label=None, shape=MAIN_SHAPE,
               params=MAIN_PARAMS, runs=(1, 2)):
    """The CLI on the stack at `src` in `mode`, `runs` times; run 1's kernel
    launches (counts set to 0 just before it); the SWC must lie on the
    tube axis. `label` names the path (default: the mode)."""
    from pnr_tpu_torch import cli

    label = label or mode
    plane = shape[0] == 1
    launches = wall = None
    for run in runs:
        tag = f"{label.replace(' ', '_')}{run}"
        if run == 1:
            scoring, undo = counting_seed_scoring()
            reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            rc = cli.main(cli_argv(src, workdir, tag, mode, params))
        finally:
            if run == 1:
                undo()
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        check(rc == 0, f"{label} CLI run {run} exited {rc}")
        rows = np.loadtxt(os.path.join(workdir, f"{tag}.swc"), comments="#", ndmin=2)
        entry = json.load(open(os.path.join(workdir, f"{tag}.json")))["stacks"][0]
        if run == 1:
            launches = read_counters()
            launches["seed_scoring"] = dict(scoring)
            # the stage graphs the warm thread captured (its `warm.capture` spans)
            launches["warm_captures"] = entry["spans"].get("warm.capture", {"n": 0})["n"]
        ys, zs = rows[:, 3], rows[:, 4]  # id type x y z r parent
        print(f"[main {label}] run {run}: {e2e:.3f} s end to end, {len(rows)} SWC nodes, median y "
              f"{np.median(ys):.3f} z {np.median(zs):.3f}, seeds {entry.get('n_raw_seeds')} raw / "
              f"{entry['n_seeds']} selected, {entry['trace_count']} traces [{card}]", flush=True)
        print(f"[main {label}] run {run} stages (s): {json.dumps(entry['timings_s'])}", flush=True)
        check(len(rows) > 10, f"{label} path SWC has more than 10 nodes")
        if plane:
            check(abs(np.median(ys) - shape[1] / 2) <= 2,
                  f"{label}: median node y within 2 of {shape[1] // 2}")
            check(bool((zs == 0).all()), f"{label}: every node at z = 0")
        else:
            check(abs(np.median(ys) - shape[1] / 2) <= 3,
                  f"{label}: median node y within 3 of {shape[1] // 2}")
            check(abs(np.median(zs) - shape[0] / 2) <= 3,
                  f"{label}: median node z within 3 of {shape[0] // 2}")
        if run == 1:
            print(f"[main {label}] kernel launches during run 1: {json.dumps(launches)}",
                  flush=True)
            check(all(launches[k] > 0 for k in PATH_KERNELS[label]),
                  f"the {label} path launched {', '.join(PATH_KERNELS[label])}")
            want_k1 = 0 if plane else len(SIGMAS) + 1
            check(launches["frangi3d_fused"] == want_k1,
                  f"the {label} path launched K1 {want_k1} times (once per sigma and its decode "
                  f"on a 3-D stack, never on a plane)")
            if mode == "exact":
                n = launches["seed_scoring"]["exact_sums"]
                check(0 < n < launches["exact_sums"],
                      "K2 was launched both by seed scoring and by the tracer")
        wall = e2e
    return launches, wall, rows


def phase_main_unfused(torch, card, main_np):
    """The slice's path: `reconstruction_func` with fused_frangi=False on
    the main stack, twice; then once with the unfused cap lowered, so the
    tiled engine streams the stack: its J8 and seeds must be the
    monolithic run's."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruct

    cfg = dataclasses.replace(PNRConfig.from_cli_params(MAIN_PARAMS), fused_frangi=False)

    def run(label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = reconstruct.reconstruction_func(main_np, cfg, verbose=False, device=DEVICE)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        ys, zs = np.asarray(res.tree.y[1:]), np.asarray(res.tree.z[1:])
        print(f"[main unfused] {label}: {e2e:.3f} s end to end, {len(ys)} SWC nodes, median y "
              f"{np.median(ys):.3f} z {np.median(zs):.3f}, seeds {res.n_raw_seeds} raw / "
              f"{len(res.seeds_pos)} selected, {res.trace_count} traces [{card}]", flush=True)
        print(f"[main unfused] {label} stages (s): {json.dumps(res.timings)}", flush=True)
        check(len(ys) > 10, f"unfused path ({label}) SWC has more than 10 nodes")
        check(abs(np.median(ys) - MAIN_SHAPE[1] / 2) <= 3, f"unfused ({label}): median y near 320")
        check(abs(np.median(zs) - MAIN_SHAPE[0] / 2) <= 3, f"unfused ({label}): median z near 64")
        return res, e2e

    reset_counters()
    mono, _ = run("run 1")
    launches = read_counters()
    print(f"[main unfused] kernel launches during run 1: {json.dumps(launches)}", flush=True)
    check(all(launches[k] > 0 for k in PATH_KERNELS["unfused"]) and launches["frangi3d_fused"] == 0,
          "the unfused path launched K3, K4 and K2, and not K1")
    _, run2_s = run("run 2")
    cap = reconstruct.UNFUSED_MAX_VOXELS
    reconstruct.UNFUSED_MAX_VOXELS = 0
    try:
        tiled, _ = run(f"tiled route (unfused cap 0, blocks {reconstruct.pick_blocks(MAIN_SHAPE, SIGMAS, ZDIST)})")
    finally:
        reconstruct.UNFUSED_MAX_VOXELS = cap
    same_seeds = ({tuple(p) for p in tiled.seeds_pos.tolist()}
                  == {tuple(p) for p in mono.seeds_pos.tolist()})
    print(f"[main unfused] tiled route vs monolithic: J8 bitwise {np.array_equal(tiled.j8, mono.j8)}, "
          f"seed sets equal {same_seeds}", flush=True)
    check(np.array_equal(tiled.j8, mono.j8) and same_seeds,
          "the tiled route's J8 and seeds are the monolithic route's")
    return launches, run2_s


#: kernel names (substrings) in the profiler's device events
PROFILE_KERNELS = {
    "K1 (frangi_fused, decode_stats)": ("frangi_fused_kernel", "decode_stats_kernel"),
    "K3 (and the map build's)": ("conv1d_axis_",),
    "K4": ("conv_yx_kernel",),
    "K2": ("exact_sums_kernel",),
    "tube_corr (K5, K6)": ("tube_corr_kernel",),
}


def phase_profile(torch, card, mode, run, unprofiled_s, label=None, want=None):
    """One more run of a path (`run()`) under torch.profiler: the card's
    busy time (union of its kernel and copy spans), idle share, per-kernel
    device time, the host's launch calls (kernel launches and CUDA graph
    launches) per tracer step (one iteration of one chunk: two K2 or
    tube_corr launches), the stream synchronisations per tracer stage, and
    in tube mode the device time per tube_corr launch. `label` names the
    run (default: the mode); `want` the kernels the profiler must see
    (default: the mode's). Prints the top device ops by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    label = label or mode
    reset_counters()
    stages, undo_stages = counting_stages()
    scoring, undo_scoring = counting_seed_scoring()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_warmup(torch)
            with record_function("chip_smoke run"):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
    finally:
        undo_stages()
        undo_scoring()
    n = read_counters()
    # the profiler's raw events (name, device, ns): building its
    # FunctionEvent list takes ~70 us an event, ~20 s for a mesh run's
    events = [(e.name(), e.device_type(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events() if not e.is_hidden_event()]
    span = next((a, b) for name, d, a, b in events
                if name == "chip_smoke run" and d == DeviceType.CPU)
    # the range's own device annotation spans the whole run: not device work
    dev = [e for e in events if e[1] == DeviceType.CUDA and not e[0].startswith("Activity Buffer")
           and "spin_kernel" not in e[0] and e[0] != "chip_smoke run"]
    check(dev, f"the profiler recorded device work in the {label} path")
    busy_ns, end = 0, -1
    for _, _, a, b in sorted(dev, key=lambda e: (e[2], e[3])):
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    busy_s = busy_ns / 1e9
    per = {}
    for name, names in PROFILE_KERNELS.items():
        hit = [e for e in dev if any(nm in e[0] for nm in names)]
        per[name] = (sum(b - a for _, _, a, b in hit) / 1e6, len(hit))

    def host_calls(*prefixes):
        return [e for e in events if e[1] == DeviceType.CPU and e[0].startswith(prefixes)
                and span[0] <= e[2] <= span[1]]

    host_launch = host_calls("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
    graph_launch = host_calls("cudaGraphLaunch")
    syncs = host_calls("cudaStreamSynchronize")
    launch_ms = sum(b - a for _, _, a, b in host_launch) / 1e6
    idle = 1 - busy_s / wall
    print(f"[profile {label}] run 3 under torch.profiler: {wall:.3f} s; card busy "
          f"{busy_s * 1e3:.3f} ms, idle {idle:.4f} of the profiled run and "
          f"{1 - busy_s / unprofiled_s:.4f} of run 2's {unprofiled_s:.3f} s [{card}]", flush=True)
    print(f"[profile {label}] " + "; ".join(
        f"{k} {ms:.3f} ms in {c} launches" for k, (ms, c) in per.items() if c)
        + f"; {len(dev)} device ops; {len(host_launch)} host launch calls taking "
          f"{launch_ms:.3f} ms ({len(graph_launch)} of them cudaGraphLaunch)", flush=True)
    tracer = (n["tube_corr_trace"] if mode.endswith("tube")
              else n["exact_sums"] - scoring["exact_sums"])
    steps = max(tracer // 2, 1)
    out = {"busy_ms": busy_s * 1e3, "kernels": per, "wall_s": wall, "idle": idle, "launches": n,
           "host_launch_calls": len(host_launch), "graph_launches": len(graph_launch),
           "steps": steps, "stages": stages["stages"], "graph_replays": n["graph_replays"],
           "stream_syncs": len(syncs),
           "host_calls_per_step": len(host_launch) / steps,
           "syncs_per_stage": len(syncs) / max(stages["stages"], 1)}
    print(f"[profile {label}] {steps} tracer steps in {stages['stages']} stages "
          f"({n['graph_replays']} of them graph replays): {out['host_calls_per_step']:.1f} host "
          f"launch calls per step (the whole run's calls over its steps); {len(syncs)} "
          f"cudaStreamSynchronize calls, {out['syncs_per_stage']:.2f} per stage [{card}]",
          flush=True)
    if mode.endswith("tube"):
        ms, c = per["tube_corr (K5, K6)"]
        print(f"[profile {label}] tube_corr {ms / max(c, 1) * 1e3:.3f} us of device time per "
              f"launch [{card}]", flush=True)
    k1 = "K1 (frangi_fused, decode_stats)"
    k3 = "K3 (and the map build's)"
    want = want or {"exact": (k1, "K2"), "tube": (k1, k3, "tube_corr (K5, K6)"),
                    "unfused": (k3, "K4", "K2"), "2d exact": (k3, "K2"),
                    "2d tube": (k3, "tube_corr (K5, K6)")}[mode]
    check(all(per[k][1] > 0 for k in want), f"the profiler saw {', '.join(want)} on the {label} path")
    by_name = {}
    for name, _, a, b in dev:
        ns, c = by_name.get(name, (0, 0))
        by_name[name] = (ns + b - a, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(f"[profile {label}] top device ops (ms in launches): " + "; ".join(
        f"{name[:80]} {ns / 1e6:.3f} in {c}" for name, (ns, c) in top), flush=True)
    return out


def counting_inits():
    """Count the tracer's `trace_init` calls (the warm thread's too);
    returns the count and an undo."""
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    counts = {"inits": 0}
    real = BatchedTracker.trace_init
    lock = threading.Lock()

    def counted(*a, **k):
        with lock:
            counts["inits"] += 1
        return real(*a, **k)

    BatchedTracker.trace_init = counted

    def undo():
        BatchedTracker.trace_init = real

    return counts, undo


#: the tracer's routes in [graphs exact] / [graphs tube], in turns: eager
#: stages, stage graphs without the warm thread (PNR_TPU_NO_WARM_ASYNC=1),
#: stage graphs with it (the default)
GRAPH_ROUTES = ("eager", "graphs", "warm", "warm", "graphs", "eager", "eager", "warm", "graphs")


def phase_graphs(torch, card, main_np, mode):
    """[graphs exact], [graphs tube]: the main stack through
    `reconstruction_func` at MAIN_PARAMS on three routes of the tracer in
    turns (GRAPH_ROUTES): eager stages (`BatchedTracker(...,
    graphs=False)`), stage graphs captured on the tracing thread at each
    key's first stage (PNR_TPU_NO_WARM_ASYNC=1), and stage graphs captured
    by the warm thread while the front runs (the default). Launch counts
    set to 0 just before each run and read just after. Checks: every run's
    tree, n0, seeds and trace count bitwise the first eager run's; the
    wave loop's two keys; with the warm thread no capture on the tracing
    thread; the tracer's launches exactly two a `trace_init` (the warm
    thread's included) and 2 * STAGE_ITERS a stage, the eager route's
    plus the warm thread's `trace_init`, and the other kernels' equal.
    Prints each run's seconds, tracing seconds, stages on the tracing
    thread by route, the warm thread's captures, seconds and the part of
    them that overlapped the front, and the graphs' memory; then one eager
    run under the profiler (the warm route's profile is [profile
    exact]/[profile tube]'s)."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruction_func
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    tag = f"graphs {mode}"
    cfg = dataclasses.replace(PNRConfig.from_cli_params(MAIN_PARAMS), zncc_mode=mode)
    tracer = "tube_corr_trace" if mode == "tube" else "exact_sums"
    runs = {r: [] for r in dict.fromkeys(GRAPH_ROUTES)}
    ref = None
    for route in GRAPH_ROUTES:
        tracker = BatchedTracker(cfg, DEVICE, graphs=route != "eager")
        if route == "graphs":
            os.environ["PNR_TPU_NO_WARM_ASYNC"] = "1"
        stages, undo_stages = counting_stages()
        inits, undo_inits = counting_inits()
        scoring, undo_scoring = counting_seed_scoring()
        reset_counters()
        try:
            res, wall = timed(torch, lambda: reconstruction_func(
                main_np, cfg, verbose=False, device=DEVICE, _tracker=tracker))
        finally:
            os.environ.pop("PNR_TPU_NO_WARM_ASYNC", None)
            undo_stages()
            undo_inits()
            undo_scoring()
        n = read_counters()
        # the run's runner (none on the eager route; on the CPU none at all)
        log = tracker.graph_log[-1] if tracker.graph_log else None
        info = {"s": wall, "tracing_s": res.timings["tracing"], "launches": n,
                "stages": stages["stages"], "inits": inits["inits"], "runner": log}
        warm = (f"; warm thread: {log['warm_captures']} captures, {log['warm_s']:.4f} s, "
                f"{log['warm_s'] - log['warm_wait_s']:.4f} s of them overlapping the front "
                f"(the tracing thread waited {log['warm_wait_s']:.4f} s); captures took "
                f"{log['capture_s']:.4f} s") if log else ""
        # the tracing thread's host ms per stage it dispatched: the wave
        # loop's commits (its `tracing.commit` spans), and on a runner its
        # staging, replay and fetch
        host_s = {"commits": res.spans.get("tracing.commit", (0.0, 0))[0],
                  **(log["host_s"] if log else {})}
        info["host_ms_per_stage"] = {k: 1e3 * v / max(1, stages["stages"])
                                     for k, v in host_s.items()}
        warm += "; host ms per stage " + json.dumps(
            {k: round(v, 4) for k, v in info["host_ms_per_stage"].items()})
        print(f"[{tag}] {route}: {wall:.3f} s, tracing {info['tracing_s']:.4f} s, "
              f"{res.trace_count} traces, {len(res.tree) - 1} SWC nodes; {stages['stages']} stages"
              f" on the tracing thread" + (f", by route {json.dumps(log['routes'])}, "
                                          f"{log['graphs']} keys" if log else "")
              + warm + f"; launches {json.dumps(n)} [{card}]", flush=True)
        if ref is None:
            ref = (res, n)
        check(same_tree(res, ref[0]), f"[{tag}] {route}: tree, n0, seeds and trace count bitwise "
                                      f"the eager run's")
        # the tracer's launches, from the code: two a trace_init, 2 * STAGE_ITERS a stage
        traced = n[tracer] - (scoring["exact_sums"] if mode == "exact" else 0)
        want = 2 * inits["inits"] + 2 * tracker.STAGE_ITERS * stages["stages"]
        check(traced == want, f"[{tag}] {route}: the tracer launched {tracer} {traced} times, "
                              f"2 x {inits['inits']} inits + 2 x {tracker.STAGE_ITERS} x "
                              f"{stages['stages']} stages = {want}")
        check(n["threefry"] == inits["inits"] + stages["stages"],
              f"[{tag}] {route}: the draws' kernel launched {n['threefry']} times, one a "
              f"trace_init ({inits['inits']}) and one a stage ({stages['stages']})")
        warm_inits = log["warm_inits"] if log else 0
        extra = {tracer: 2 * warm_inits, "threefry": warm_inits}
        kernels = {k: v for k, v in n.items() if not k.startswith("graph_")}
        want_k = {k: v + extra.get(k, 0) for k, v in ref[1].items() if not k.startswith("graph_")}
        check(kernels == want_k, f"[{tag}] {route}: the eager run's kernel launches, plus the warm "
                                 f"thread's trace_init ({extra})")
        check((n["graph_replays"] > 0) == (route != "eager"),
              f"[{tag}] {route}: graph replays {'in' if route != 'eager' else 'not in'} the run")
        if log:
            check(log["graphs"] == 2, f"[{tag}] {route}: the wave loop used two keys "
                                      f"({log['graphs']})")
            if route == "warm":
                check(log["warm_captures"] == 2 and log["routes"]["capture"] == 0
                      and res.spans.get("warm.capture", (0.0, 0))[1] == 2,
                      f"[{tag}] warm: both keys captured by the warm thread, none on the tracing "
                      f"thread")
            else:
                check(log["warm_captures"] == 0 and log["routes"]["capture"] == 2,
                      f"[{tag}] graphs: both keys captured at their first stage")
        runs[route].append(info)
        del tracker, res
    g = runs["warm"][-1]["runner"] or {"reserved_bytes": 0, "graphs": 0}
    print(f"[{tag}] the graphs' memory: {g['reserved_bytes']} bytes reserved while capturing "
          f"{g['graphs']} graphs; the allocator's peak reserved "
          f"{torch.cuda.memory_stats()['reserved_bytes.all.peak']} bytes [{card}]", flush=True)
    for key in ("s", "tracing_s"):
        print(f"[{tag}] {key} (in turns) " + ", ".join(
            f"{route} {[round(r[key], 4) for r in rs]}" for route, rs in runs.items())
            + f" [{card}]", flush=True)
    for route in runs:
        print(f"[{tag}] {route}: the tracing thread's host ms per stage (the wave loop's "
              f"commits; replayed: staging writes, replay call, fetch wait), per run: " + json.dumps(
                  [{k: round(v, 4) for k, v in r["host_ms_per_stage"].items()}
                   for r in runs[route]]) + f" [{card}]", flush=True)
    eager_s = statistics.median(r["s"] for r in runs["eager"])
    profile = phase_profile(
        torch, card, mode,
        lambda: reconstruction_func(main_np, cfg, verbose=False, device=DEVICE,
                                    _tracker=BatchedTracker(cfg, DEVICE, graphs=False)),
        eager_s, label=f"{tag} eager")
    return {**runs, "eager_profile": profile, "launches": ref[1]}


def phase_small_agreement(torch, mode):
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruction_func

    vol = make_volume((24, 64, 96), seed=7)
    cfg = PNRConfig(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                    ni=100, np=20, zdist=ZDIST, nodepervol=4, vol=9, zncc_mode=mode)
    gpu = reconstruction_func(vol, cfg, verbose=False, device=DEVICE)
    cpu = reconstruction_func(vol, cfg, verbose=False, device="cpu")
    sg = {tuple(p) for p in gpu.seeds_pos.astype(int).tolist()}
    sc = {tuple(p) for p in cpu.seeds_pos.astype(int).tolist()}
    overlap = len(sg & sc) / max(len(sg), len(sc), 1)
    dy = abs(np.median(gpu.tree.y[1:]) - np.median(cpu.tree.y[1:]))
    dz = abs(np.median(gpu.tree.z[1:]) - np.median(cpu.tree.z[1:]))
    print(f"[small {mode}] card vs plain CPU: seed overlap {overlap:.3f}, nodes "
          f"{len(gpu.tree) - 1} vs {len(cpu.tree) - 1}, traces {gpu.trace_count} vs "
          f"{cpu.trace_count}, median |dy| {dy:.3f} |dz| {dz:.3f}", flush=True)
    check(overlap >= 0.9, f"small stack, {mode}: seed sets agree")
    check(len(gpu.tree) > 10 and dy < 2.0 and dz < 2.0, f"small stack, {mode}: trees agree")


# -- the 2-D (one-plane) and soma paths -----------------------------------


def plane_queries(rng, shape, t, b, anywhere=0.25):
    """Trace clouds on a one-plane stack: centres near the tube axis (y =
    h / 2), a share anywhere on the plane, B particles within 4 pixels of
    each centre, z = 0; directions in the plane, half roughly along x."""
    _, h, w = shape
    centre = np.stack([rng.uniform(0, w - 1, t), rng.normal(h / 2, 2.0, t)], -1)
    move = rng.random(t) < anywhere
    centre[move] = np.stack([rng.uniform(0, w - 1, t), rng.uniform(0, h - 1, t)], -1)[move]
    xy = centre[:, None, :] + (rng.uniform(-4, 4, (t, b, 2)) if b > 1 else 0.0)
    pos = np.concatenate([xy, np.zeros((t, b, 1))], -1)
    a = rng.uniform(0, 2 * np.pi, (t, b))
    a[: t // 2] = rng.normal(0, 0.3, (t // 2, b))
    d = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)], -1)
    return pos.astype(np.float32), d.astype(np.float32)


def phase_k2_2d(torch, card, plane_vol):
    """K2 on one-plane patches (pz = 1) of the 2-D main plane against its
    plain version: one tracer chunk (T=128, B=20) and B=1 scoring, at K2's
    bars and bitwise over two launches; slabs per trace, shared memory per
    block, time per call back to back, the plain version's, grid_sample's
    at the same samples, and the bound."""
    import torch.nn.functional as F

    from pnr_tpu_torch.ops import zncc_exact as ze
    from pnr_tpu_torch.ops.zncc_exact import (
        ExactPatchEngine, ZnccTemplates, exact_corr_from_sums, exact_sums, exact_sums_plain,
    )

    dev = plane_vol.device
    eng = ExactPatchEngine(ZnccTemplates(SIGMAS, True), 2, dev)
    rng = np.random.default_rng(21)
    out, worst = {}, 0.0
    for key, t, b in (("t128_b20", 128, 20), ("t512_b1", 512, 1)):
        pos, d = (torch.from_numpy(a).to(dev) for a in plane_queries(rng, PLANE_SHAPE, t, b))
        corner = eng.corners(plane_vol.shape, pos.mean(dim=1))
        qs = eng.qinfo(plane_vol, corner, pos, d)
        dims = eng.dims(plane_vol.shape)
        plan = ze.kernel_plan(dims, b, len(SIGMAS))
        smem = ze.smem_bytes(plan, dims[1], b, len(SIGMAS))

        def kern():
            return exact_sums(plane_vol, corner, qs, eng.tables, dims)

        sk = kern()
        same = bool(torch.equal(sk, kern()))
        sp = exact_sums_plain(plane_vol, corner, qs, eng.tables, dims)
        col_err = [float((sk[..., i] - sp[..., i]).abs().max()) /
                   max(float(sp[..., i].abs().max()), 1.0) for i in range(3)]
        ck, sgk = exact_corr_from_sums(eng.tables, sk)
        cp, sgp = exact_corr_from_sums(eng.tables, sp)
        cerr = float((ck - cp).abs().max())
        agree = float((sgk == sgp).float().mean())
        worst = max(worst, cerr)
        grid, shapes = k2_sample_grid(torch, eng, plane_vol, corner, qs)
        vol_f = plane_vol.to(torch.float32)[None, None]

        def lib():
            return F.grid_sample(vol_f, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)

        ms, lib_ms = time_turns_ms(torch, (kern, lib), calls=20)
        plain_ms = time_ms(torch, lambda: exact_sums_plain(plane_vol, corner, qs, eng.tables, dims))
        samples = t * b * int(eng.tables.cnt.sum())
        nbytes = (min(t * dims[0] * dims[1] * dims[2], plane_vol.numel()) + qs.numel() * 4
                  + corner.numel() * 4 + eng.tables.tab.numel() * 4 + sk.numel() * 4)
        out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "slabs": plan.nz,
                    "smem_bytes": smem, "samples": samples, "max_col_err": max(col_err),
                    **bound(nbytes, samples * K2_PLANE_SAMPLE_FLOPS)}
        print(f"[K2 2d] {PLANE_SHAPE} T={t} B={b} patch {dims}: {plan.nz} slab of {plan.step} "
              f"floors a trace, {smem} bytes of shared memory a block; sums max|d|/max|plain| per "
              f"column {', '.join(f'{e:.3e}' for e in col_err)}; corr max|d| {cerr:.3e}; sigma "
              f"agreement {agree:.4f}; two launches bitwise equal {same}; {ms:.4f} ms per call "
              f"back to back, grid_sample (sampling only) {lib_ms:.4f}, plain {plain_ms:.3f}; "
              f"bound {out[key]['bound_ms']:.5f} ms ({out[key]['bound_by']}) [{card}]", flush=True)
        check(plan.nz == 1 and plan.step == 0, "K2 2d: one slab of one plane a trace")
        check(max(col_err) < 1e-5, f"K2 2d T={t} B={b}: sums within 1e-5 of each column's scale")
        check(cerr < 3e-4 and agree > 0.97,
              f"K2 2d T={t} B={b}: corr atol 3e-4 and sigma agreement > 97%")
        check(same, f"K2 2d T={t} B={b}: two launches bitwise equal")
        del grid
    return {"max_abs_err": worst, **out}


def phase_maps_2d(torch, card, plane_vol):
    """The 2-D map build (y and x passes on K3) of the main plane against
    the plain shift-and-add; K3 on the plane timed along x from uint8 and
    along y from float32 at sigma 6 (the 2-D Gaussians' passes)."""
    from pnr_tpu_torch.ops import conv, gaussian
    from pnr_tpu_torch.ops.gaussian import gaussian_kernel
    from pnr_tpu_torch.ops.zncc_fast import (
        TubeZnccModel, build_tube_maps_packed, build_tube_maps_packed_plain,
    )

    model = TubeZnccModel(SIGMAS, True)
    n0 = gaussian.LAUNCHES
    field = build_tube_maps_packed(plane_vol, model)
    launches = gaussian.LAUNCHES - n0
    plain = build_tube_maps_packed_plain(plane_vol, model)
    s_, z, y, x3 = field.shape
    errs = col_errs(field.view(s_, z, y, x3 // 3, 3), plain.view(s_, z, y, x3 // 3, 3))
    del plain
    print(f"[maps 2d] {PLANE_SHAPE} sigmas {SIGMAS}: field {tuple(field.shape)} "
          f"{field.numel() * 4 / 1e9:.3f} GB, {launches} K3 launches; max|d|/max(|plain|,1) per "
          f"channel {', '.join(f'{e:.3e}' for e in errs)}", flush=True)
    check(launches == 6 * len(SIGMAS), "2-D map build: y and x passes only (6 K3 launches a sigma)")
    check(max(errs) < 1e-5, "2-D map build: per channel max|d| / max(|plain|, 1) < 1e-5")
    ms = time_ms(torch, lambda: build_tube_maps_packed(plane_vol, model))
    plain_ms = time_ms(torch, lambda: build_tube_maps_packed_plain(plane_vol, model))
    k = gaussian_kernel(SIGMAS[-1])
    n = plane_vol.numel()
    vf = plane_vol.to(torch.float32)
    k3 = {}
    for label, v, axis, inb in (("x from u8", plane_vol, 2, 1), ("y from f32", vf, 1, 4)):
        e = conv_err(conv.conv1d_axis(v, k, axis), conv.conv1d_axis_plain(v, k, axis))
        check(e < 1e-5, f"K3 on the plane, {label}: within 1e-5 of max|plain|")

        def library(v=v, axis=axis):
            return conv2d_replicate(torch, v, k, axis)

        e_lib = conv_err(library(), conv.conv1d_axis_plain(v, k, axis))
        check(e_lib < 1e-5, f"conv2d on the plane, {label}: within 1e-5 of max|plain|")
        ms, lib_ms = time_turns_ms(
            torch, [lambda v=v, axis=axis: conv.conv1d_axis(v, k, axis), library], reps=11)
        k3[label] = {"ms": ms, "library_ms": lib_ms,
                     "plain_ms": time_ms(torch, lambda v=v, axis=axis:
                                         conv.conv1d_axis_plain(v, k, axis)),
                     "max_rel_err": e, **bound(n * (inb + 4), n * 2 * len(k))}
    print(f"[maps 2d] build: kernel route {ms:.3f} ms, plain {plain_ms:.3f} ms; K3 on the plane, "
          f"{len(k)} taps: " + "; ".join(
              f"{lb} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} "
              f"{r['bound_by']}, max|d|/max|plain| {r['max_rel_err']:.3e})" for lb, r in k3.items())
          + f" [{card}]", flush=True)
    print("[maps 2d] K3 in turns with one conv2d (replicate padding and, from u8, the cast "
          "included; TF32 off): " + "; ".join(
              f"{lb} {r['ms']:.4f} ms, conv2d {r['library_ms']:.4f} ms" for lb, r in k3.items())
          + f" [{card}]", flush=True)
    return field, {"max_rel_err": max(errs), "ms": ms, "plain_ms": plain_ms, "k3": k3}


def conv2d_replicate(torch, plane, taps, axis):
    """The library call for K3 on a (1, Y, X) plane along y (axis 1) or x
    (axis 2): one `conv2d` of the float32 plane, edge-replicated by
    `F.pad`, with the (1, 1, n, 1) or (1, 1, 1, n) taps."""
    import torch.nn.functional as F

    h = len(taps) // 2
    w = torch.as_tensor(np.asarray(taps, np.float32), device=plane.device)
    w = w.view(1, 1, -1, 1) if axis == 1 else w.view(1, 1, 1, -1)
    pad = (0, 0, h, h) if axis == 1 else (h, h, 0, 0)
    x = F.pad(plane.to(torch.float32)[None], pad, mode="replicate")
    return F.conv2d(x, w)[0]


def phase_tube_corr_2d(torch, card, field):
    """tube_corr on the main plane's one-plane windows against its plain
    chain: the tracer's row (T=128, N=20) and the scoring row (T=512,
    B=1), at the existing bars, timed as phase_tube_corr times them."""
    from pnr_tpu_torch.ops.zncc_fast import TubePatchEngine, TubeZnccModel

    dev = field.device
    eng = TubePatchEngine(TubeZnccModel(SIGMAS, True), 2, 1.0, device=dev)
    rng = np.random.default_rng(22)
    pos, d = (torch.from_numpy(a).to(dev) for a in plane_queries(rng, PLANE_SHAPE, 128, 20))
    lay, corners, err5 = tube_corr_compare(torch, eng, field, "tube_corr 2d tracer", pos, d, False)
    check(all(g[2][0] == 1 for g in lay.groups), "tube_corr 2d: one-plane windows")
    k5 = {"max_abs_err": err5, **tube_corr_row(torch, card, eng, field, "tube_corr 2d tracer",
                                               lay, corners, pos, d, False)}
    pos, d = (torch.from_numpy(a).to(dev) for a in plane_queries(rng, PLANE_SHAPE, 512, 1))
    lay, corners, err6 = tube_corr_compare(torch, eng, field, "tube_corr 2d scoring", pos, d, True)
    k6 = {"max_abs_err": err6, **tube_corr_row(torch, card, eng, field, "tube_corr 2d scoring",
                                               lay, corners, pos, d, True)}
    return k5, k6


def phase_soma(torch, card, soma_np):
    """`soma_extraction` on the card and on the CPU plain path on the soma
    stack: the eroded, smoothed stack (K3's x pass from u8 and y pass from
    f32) bitwise, and the soma maps, thresholds and soma nodes equal; the
    stage's parts on the card."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.graph.nodes import NodeList
    from pnr_tpu_torch.ops.gaussian import imgaussian_xy
    from pnr_tpu_torch.ops.morphology import imerode_xy
    from pnr_tpu_torch.ops.thresholds import maxentropy_th
    from pnr_tpu_torch.pipeline.reconstruct import soma_extraction

    cfg = PNRConfig.from_cli_params(SOMA_PARAMS)
    r = float(cfg.somaradius)
    out = []
    for dev in (DEVICE, "cpu"):
        nodes, parts = NodeList(), {}
        if dev == DEVICE:
            soma_extraction(soma_np, cfg, NodeList(), dev)  # warm-up
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        smap = soma_extraction(soma_np, cfg, nodes, dev, parts)
        if dev == DEVICE:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e8 = imgaussian_xy(imerode_xy(torch.from_numpy(soma_np).to(dev), r), r).cpu()
        out.append((smap, nodes, dt, e8, maxentropy_th(e8), parts))
    (smap_c, nodes_c, dt_c, e8_c, th_c, parts), (smap_h, nodes_h, dt_h, e8_h, th_h, _) = out
    e8d = (e8_c.int() - e8_h.int()).abs()
    rows = [(nodes_c.x[i], nodes_c.y[i], nodes_c.z[i], nodes_c.sig[i]) for i in range(1, len(nodes_c))]
    same_nodes = rows == [(nodes_h.x[i], nodes_h.y[i], nodes_h.z[i], nodes_h.sig[i])
                          for i in range(1, len(nodes_h))]
    print(f"[soma] {soma_np.shape} somaradius {r:g}: stage {dt_c:.3f} s on the card, {dt_h:.3f} s "
          f"on the CPU plain path; threshold {th_c} (CPU {th_h}); {len(rows)} regions: "
          + ", ".join(f"({x:.1f}, {y:.1f}, {z:.1f}) r {sg:.2f}" for x, y, z, sg in rows)
          + f"; eroded, smoothed stack max|d| {int(e8d.max())} on "
          f"{float((e8d > 0).float().mean()):.3e} of voxels; soma maps equal "
          f"{np.array_equal(smap_c, smap_h)}, nodes equal {same_nodes} [{card}]", flush=True)
    print(f"[soma] the stage's parts on the card (s): {json.dumps(parts)} [{card}]", flush=True)
    check(int(e8d.max()) == 0, "soma: the card's eroded, smoothed stack is the CPU's, bitwise")
    check(np.array_equal(smap_c, smap_h), "soma: the card's soma map is the CPU's")
    check(th_c == th_h and same_nodes, "soma: the card's threshold and soma nodes are the CPU's")
    return {"card_s": dt_c, "cpu_s": dt_h, "threshold": th_c, "regions": len(rows),
            "parts_s": parts}


def phase_tiled_2d(torch, card):
    """`frangi2d_tiled` at `pick_blocks_2d`'s blocks bitwise the monolithic
    `frangi2d` on a plane over the 80-Mpx cutover; the peak device bytes
    per pixel of both routes."""
    from pnr_tpu_torch.ops.frangi import frangi2d
    from pnr_tpu_torch.ops.frangi_blocked import frangi2d_tiled, pick_blocks_2d
    from pnr_tpu_torch.pipeline import reconstruct

    t0 = time.perf_counter()
    img = torch.from_numpy(make_volume(TILED_PLANE_SHAPE, seed=3)[0]).to(DEVICE)
    made = time.perf_counter() - t0
    n = img.numel()
    check(n > reconstruct.FRANGI2D_TILED_PIXELS, "the plane is over the 2-D tiling cutover")
    by, bx = pick_blocks_2d(tuple(img.shape), SIGMAS)
    peaks = {
        "frangi2d": peak_bytes_per_voxel(torch, lambda: frangi2d(img, SIGMAS), n),
        f"frangi2d_tiled ({by}, {bx})": peak_bytes_per_voxel(
            torch, lambda: frangi2d_tiled(img, SIGMAS, block_y=by, block_x=bx), n),
    }
    times = {}
    for label, fn in (("frangi2d", lambda: frangi2d(img, SIGMAS)),
                      ("frangi2d_tiled", lambda: frangi2d_tiled(img, SIGMAS, block_y=by,
                                                                block_x=bx))):
        times[label] = time_ms(torch, fn, reps=3)
    mono = frangi2d(img, SIGMAS)
    tiled = frangi2d_tiled(img, SIGMAS, block_y=by, block_x=bx)
    same = [bool(torch.equal(tiled[i], mono[i])) for i in (0, 3, 4)]
    jmin_eq, jmax_eq = float(tiled[1]) == float(mono[1]), float(tiled[2]) == float(mono[2])
    print(f"[tiled 2d] {TILED_PLANE_SHAPE} (made in {made:.3f} s), blocks ({by}, {bx}): J, Vx, Vy "
          f"bitwise {same}, Jmin {jmin_eq}, Jmax {jmax_eq}; frangi2d {times['frangi2d']:.3f} ms, "
          f"tiled {times['frangi2d_tiled']:.3f} ms; peak device bytes per pixel above the plane "
          f"{json.dumps({k: round(v, 3) for k, v in peaks.items()})} [{card}]", flush=True)
    check(all(same) and jmin_eq and jmax_eq, "frangi2d_tiled is bitwise frangi2d at 85 Mpx")
    return {"blocks": [by, bx], "peaks": peaks, "ms": times}


#: the quality phantoms' configurations: tests/test_phantom_neuron.py's
#: CFG (tube mode, sigmas (2, 3)), with Test2DPhantom's zdist 1.0,
#: TestMultiNeuronSoma's somaradius 4, and TestBranchingNeuronExact's exact
#: mode at ni 40; each phantom's own bars
PHANTOM_CFG = dict(sigmas=(2.0, 3.0), tolerance=10.0, znccth=0.5, kappa=2.0, step=2, ni=60,
                   np=16, zdist=2.0, nodepervol=4, vol=9, wave_size=32, zncc_mode="tube")
QUALITY = {
    "2d exact": ("branching_neuron_phantom_2d", dict(zdist=1.0, zncc_mode="exact"),
                 (0.75, 0.85, 0.0)),
    "2d tube": ("branching_neuron_phantom_2d", dict(zdist=1.0), (0.75, 0.85, 0.0)),
    "soma": ("multi_neuron_soma_phantom", dict(somaradius=4), (0.75, 0.8, 0.0)),
    "3d exact": ("branching_neuron_phantom", dict(zncc_mode="exact", ni=40), (0.8, 0.85, 0.85)),
}


def phase_quality(torch, card):
    """The phantoms through the pipeline on the card and on the CPU plain
    path in the same process, scored with the port's `compare_swc`
    against gold: the card's F1 within 0.05 of the CPU's, and each
    phantom test's bars on the card."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_phantoms as phantoms

    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.graph.nodes import SOMA
    from pnr_tpu_torch.io.swc import read_swc, save_nodelist
    from pnr_tpu_torch.pipeline import reconstruction_func
    from pnr_tpu_torch.utils.swc_compare import compare_swc

    out = {}
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_quality_", dir=HERE)
    try:
        for key, (name, over, (rmin, pmin, fmin)) in QUALITY.items():
            vol, gold = getattr(phantoms, name)()
            cfg = PNRConfig(**{**PHANTOM_CFG, **over})
            scores = []
            for i, dev in enumerate((DEVICE, "cpu")):
                res = reconstruction_func(vol, cfg, verbose=False, device=dev)
                path = os.path.join(tmp, f"{key.replace(' ', '_')}_{i}.swc")
                save_nodelist(res.tree, path)
                scores.append((compare_swc(read_swc(path), gold, dist=4.0, resample=1.0), res))
            (sc, rc_), (sh, _) = scores
            print(f"[quality] {key} ({name}): card recall {sc.recall:.4f} precision "
                  f"{sc.precision:.4f} F1 {sc.f1:.4f}; CPU recall {sh.recall:.4f} precision "
                  f"{sh.precision:.4f} F1 {sh.f1:.4f}; paired |dF1| {abs(sc.f1 - sh.f1):.4f}",
                  flush=True)
            check(abs(sc.f1 - sh.f1) <= 0.05, f"quality {key}: card F1 within 0.05 of the CPU's")
            check(sc.recall > rmin and sc.precision > pmin and sc.f1 > fmin,
                  f"quality {key}: the phantom's bars on the card (recall > {rmin}, precision > "
                  f"{pmin}, F1 > {fmin})")
            if key.startswith("2d"):
                check(np.allclose(rc_.tree.z[1:], 0.0, atol=1.0), f"quality {key}: in the plane")
            if key == "soma":
                somas = [(rc_.n0.x[i], rc_.n0.y[i]) for i in range(1, len(rc_.n0))
                         if rc_.n0.type[i] == SOMA]
                check(len(somas) == 2 and all(
                    min(np.hypot(x - sx, y - sy) for x, y in somas) < 3.0
                    for sx, sy in ((24, 28), (104, 68))), "quality soma: both somas found")
            out[key] = {"card": [sc.recall, sc.precision, sc.f1],
                        "cpu": [sh.recall, sh.precision, sh.f1]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


#: the stacks of the serving phases: make_volume(MAIN_SHAPE, seed=i)
BATCH_STACKS = 4
#: the stages of a stack's front (everything up to seed selection)
FRONT_STAGES = ("soma extraction", "frangi", "seed extraction", "seed selection & sorting")
#: the serving path's kernels, as read from the launch counters
BATCH_KERNELS = {"K1": ("frangi3d_fused",), "K2": ("exact_sums",),
                 "K3": ("conv1d_axis", "conv1d_along_axis"),
                 "tube_corr": ("tube_corr_trace", "tube_corr_score"), "threefry": ("threefry",)}


def kernel_launches(counts):
    return {k: sum(counts[n] for n in names) for k, names in BATCH_KERNELS.items()}


def same_tree(a, b):
    """Bitwise equal trees, raw node graphs, seeds and trace counts."""
    if a.trace_count != b.trace_count or not np.array_equal(a.seeds_pos, b.seeds_pos):
        return False
    for na, nb in ((a.tree, b.tree), (a.n0, b.n0)):
        if len(na) != len(nb) or na.nbr != nb.nbr:
            return False
        for f in ("x", "y", "z", "sig", "corr", "type"):
            if not np.array_equal(np.asarray(getattr(na, f)), np.asarray(getattr(nb, f))):
                return False
    return True


def run_batch(torch, vols, cfg, prefetch):
    """One `reconstruction_batch` on the card: the results, each stack's
    seconds (from the previous result, or the start, to its own), the
    device's peak bytes while each stack was the newest in flight (the
    peak reset at each result), the whole batch's peak, and the kernel
    launches (counts set to 0 just before, read just after; per stack
    too, read at each result: exact only without prefetch, since the
    workers run later stacks' fronts meanwhile), and each stack's
    stage-graph runner's `stats()` (the batch's tracker's `graph_log`)."""
    from pnr_tpu_torch.pipeline import reconstruct, reconstruction_batch

    made = []
    real = reconstruct.BatchedTracker

    def keep(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    results, secs, peaks, launches = [], [], [], []
    batch_peak = 0
    last = read_counters()
    t0 = time.perf_counter()
    reconstruct.BatchedTracker = keep
    try:
        for res in reconstruction_batch(vols, cfg, prefetch=prefetch, device=DEVICE):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            results.append(res)
            secs.append(t1 - t0)
            peak = torch.cuda.max_memory_allocated() - base
            peaks.append(peak)
            batch_peak = max(batch_peak, peak)
            now = read_counters()
            launches.append(kernel_launches({k: now[k] - last[k] for k in now}))
            last = now
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
    finally:
        reconstruct.BatchedTracker = real
    total = kernel_launches(read_counters())
    return {"results": results, "s": secs, "peaks": peaks, "peak": batch_peak,
            "launches": launches, "total": total,
            "graph_logs": [log for t in made for log in t.graph_log]}


def phase_batch(torch, card, vols, mode):
    """[batch exact] / [batch tube]: the stacks through
    `reconstruction_batch` with prefetch on and off in turns (on, off,
    off, on): every run's trees bitwise the first's, the launches of a
    prefetched batch equal to those of one by one; per stack its seconds,
    peak bytes and launches; the share of the front the prefetch hid; one
    front's peak within 1% of `front_device_bytes`' model, and a prefetched
    batch's within a single run's plus two modelled fronts'."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruct

    tag = f"batch {mode}"
    cfg = dataclasses.replace(PNRConfig.from_cli_params(MAIN_PARAMS), zncc_mode=mode)
    n = len(vols)
    held, peak = reconstruct.front_device_bytes(tuple(vols[0].shape), cfg)

    def peak_above(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    # one stack alone in a fresh tracer, and one front alone (warm)
    single_peak = peak_above(
        lambda: reconstruct.reconstruction_func(vols[0], cfg, verbose=False, device=DEVICE))
    tracker = reconstruct.BatchedTracker(cfg, DEVICE)

    def front():
        # the front and its warm thread's graphs, dropped as a stack's
        # tracing would
        f = reconstruct._stack_front(vols[0], cfg, torch.device(DEVICE), verbose=False,
                                     tracker=tracker)
        tracker.drop_stage_graphs(f.field)

    front()
    front_peak = peak_above(front)
    del tracker
    print(f"[{tag}] one front's peak {front_peak} bytes ({front_peak / vols[0].size:.3f} a "
          f"voxel), front_device_bytes' {peak} ({peak / vols[0].size:.3f}) [{card}]", flush=True)
    check(front_peak <= 1.01 * peak, f"{tag}: a front's peak within 1% of front_device_bytes'")
    runs = {True: [], False: []}
    for prefetch in (True, False, False, True):
        runs[prefetch].append(run_batch(torch, vols, cfg, prefetch))
    ref = runs[False][0]["results"]
    for prefetch, rs in runs.items():
        for r in rs:
            check(all(same_tree(a, b) for a, b in zip(r["results"], ref)) and
                  len(r["results"]) == n, f"{tag}: prefetch={prefetch} bitwise the one-by-one run")
            check(r["total"] == runs[False][0]["total"],
                  f"{tag}: a batch's launches ({r['total']}) equal the stacks' one by one "
                  f"({runs[False][0]['total']})")
    want = ("K1", "K2") if mode == "exact" else ("K1", "K3", "tube_corr")
    check(all(runs[True][0]["total"][k] > 0 for k in want),
          f"{tag}: the batch launched {', '.join(want)}")
    for prefetch, rs in runs.items():
        for j, r in enumerate(rs):
            logs = r["graph_logs"]
            print(f"[{tag}] prefetch={prefetch} run {j + 1}: per stack, captures on the tracing "
                  f"thread {[log['routes']['capture'] for log in logs]}, replays "
                  f"{[log['routes']['replay'] for log in logs]}, warm captures "
                  f"{[log['warm_captures'] for log in logs]}, warm seconds "
                  f"{[round(log['warm_s'], 4) for log in logs]}, waited for "
                  f"{[round(log['warm_wait_s'], 4) for log in logs]} [{card}]", flush=True)
            check(len(logs) == n and all(log["routes"]["capture"] == 0 for log in logs[1:]),
                  f"{tag}: prefetch={prefetch} run {j + 1}: no capture on the tracing thread "
                  f"after the first stack")
    for prefetch, rs in runs.items():
        for j, r in enumerate(rs):
            print(f"[{tag}] prefetch={prefetch} run {j + 1}: {sum(r['s']):.3f} s for {n} stacks; "
                  f"per stack s {[round(x, 4) for x in r['s']]}; peak device bytes per stack "
                  f"{r['peaks']} (batch {r['peak']}); launches {json.dumps(r['total'])}; per "
                  f"stack {json.dumps(r['launches'])} [{card}]", flush=True)
    on = statistics.mean(sum(r["s"]) for r in runs[True])
    off = statistics.mean(sum(r["s"]) for r in runs[False])
    fronts = [sum(res.timings.get(k, 0.0) for k in FRONT_STAGES) for res in ref]
    hideable = sum(fronts[1:])
    hidden = (off - on) / hideable if hideable else 0.0
    model = single_peak + 2 * peak
    print(f"[{tag}] seconds per stack: prefetch {on / n:.4f}, one by one {off / n:.4f}; the "
          f"fronts (s) {[round(f, 4) for f in fronts]}, of stacks 2-{n} {hideable:.4f} s; hidden "
          f"{off - on:.4f} s = {hidden:.4f} of them [{card}]", flush=True)
    print(f"[{tag}] peak device bytes: a single run {single_peak} "
          f"({single_peak / vols[0].size:.3f} a voxel), a prefetched batch "
          f"{max(r['peak'] for r in runs[True])}, one by one {max(r['peak'] for r in runs[False])}; "
          f"front_device_bytes: held {held} ({held / vols[0].size:.1f} a voxel), peak {peak} "
          f"({peak / vols[0].size:.1f}); a single run plus two fronts' peaks {model}", flush=True)
    check(max(r["peak"] for r in runs[True]) <= model,
          f"{tag}: a prefetched batch's peak within a single run plus two fronts' modelled peaks")
    return {"s_per_stack_prefetch": on / n, "s_per_stack_one_by_one": off / n,
            "front_s": fronts, "hidden_share": hidden, "single_peak": single_peak,
            "front_peak": front_peak, "front_model_peak": peak,
            "batch_peak": max(r["peak"] for r in runs[True]), "model_peak": model,
            "launches": runs[True][0]["total"]}, ref


def phase_serve(torch, card, vols, batch_results, workdir):
    """[serve]: `watch_and_reconstruct` on a directory holding stacks 0 and
    1; stack 2 is written once the server has served one, then `.stop`:
    three SWCs, each the text of the exact batch's tree for its index."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.io.swc import save_nodelist
    from pnr_tpu_torch.pipeline import watch_and_reconstruct

    cfg = PNRConfig.from_cli_params(MAIN_PARAMS)
    d = os.path.join(workdir, "watch")
    os.makedirs(d)
    names = [f"s{i}.npy" for i in range(3)]
    for name, vol in zip(names[:2], vols):
        np.save(os.path.join(d, name), vol)
    errors = []

    def drop_third():
        try:
            first = os.path.join(d, names[0] + "_Advantra.swc")
            deadline = time.monotonic() + 120
            while not os.path.exists(first) and time.monotonic() < deadline:
                time.sleep(0.05)
            tmp = os.path.join(d, "arriving.tmp")
            with open(tmp, "wb") as f:
                np.save(f, vols[2])
            os.replace(tmp, os.path.join(d, names[2]))
            time.sleep(0.5)
            open(os.path.join(d, ".stop"), "w").close()
        except OSError as e:
            errors.append(e)
            open(os.path.join(d, ".stop"), "w").close()

    writer = threading.Thread(target=drop_third)
    writer.start()
    t0 = time.perf_counter()
    served = watch_and_reconstruct(d, cfg, poll_s=0.2, verbose=False, device=DEVICE)
    wall = time.perf_counter() - t0
    writer.join(timeout=60)
    check(not errors and not writer.is_alive(), f"[serve] the writer thread: {errors}")
    same = []
    for i, name in enumerate(names):
        out = os.path.join(d, name + "_Advantra.swc")
        ref = os.path.join(workdir, f"serve_ref{i}.swc")
        save_nodelist(batch_results[i].tree, ref, ntype=-1, sig2r=1.0, name="Advantra",
                      comment=cfg.provenance_comment())
        same.append(os.path.exists(out) and open(out).read() == open(ref).read())
    print(f"[serve] {served} stacks served in {wall:.3f} s (the third written after the first "
          f"SWC); SWC equal to the batch's tree for its index: {same} [{card}]", flush=True)
    check(served == 3 and all(same), "[serve] three SWCs, each the exact batch's tree")
    return {"served": served, "s": wall}


def phase_checkpoint(torch, card, main_np, workdir):
    """[checkpoint]: the exact main stack with a checkpoint after every
    wave (each write timed); then a run cut by the trace cap mid-wave,
    checkpointed, resumed with the cap lifted: bitwise the uninterrupted
    run."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruct

    cfg = PNRConfig.from_cli_params(MAIN_PARAMS)
    save = reconstruct.save_checkpoint
    writes = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        save(*a, **k)
        writes.append(time.perf_counter() - t0)

    ck = os.path.join(workdir, "run.npz")
    reconstruct.save_checkpoint = timed
    try:
        t0 = time.perf_counter()
        full = reconstruct.reconstruction_func(main_np, cfg, verbose=False, device=DEVICE,
                                               checkpoint_path=ck, checkpoint_every_waves=1)
        wall = time.perf_counter() - t0
    finally:
        reconstruct.save_checkpoint = save
    size = os.path.getsize(ck)
    print(f"[checkpoint] {MAIN_SHAPE} exact: {len(writes)} waves, a checkpoint after each: "
          f"{size} bytes, write s {[round(w, 4) for w in writes]} (median "
          f"{statistics.median(writes):.4f}); the run {wall:.3f} s, tracing "
          f"{full.timings['tracing']:.3f} s [{card}]", flush=True)
    cap = max(1, full.trace_count // 2)
    cut_ck = os.path.join(workdir, "cut.npz")
    part = reconstruct.reconstruction_func(main_np, dataclasses.replace(cfg, max_trace_count=cap),
                                           verbose=False, device=DEVICE, checkpoint_path=cut_ck)
    pending = int(np.load(cut_ck)["pending"].size)
    resumed = reconstruct.reconstruction_func(main_np, cfg, verbose=False, device=DEVICE,
                                              checkpoint_path=cut_ck, resume=True)
    same = same_tree(resumed, full)
    print(f"[checkpoint] cut at {part.trace_count} of {full.trace_count} traces ({pending} "
          f"selected seeds pending), resumed: bitwise the uninterrupted run {same}", flush=True)
    check(0 < part.trace_count < full.trace_count and same,
          "[checkpoint] a cap-cut run resumed is bitwise the uninterrupted run")
    return {"waves": len(writes), "write_s": writes, "bytes": size}


MIDRES_SUFFIXES = (
    ["_Advantra.swc", "_J8.tif", "_Seeds.swc", "_VxVyVz.swc", "_TraceDensity.tif"]
    + [f"_{n}_.swc" for n in ("n0", "n0tree", "n0res", "n1", "n2", "n2tree")]
    + [f"_{n}_.log" for n in ("n0len", "n0corr", "n1len")]
)


def phase_midres(torch, card, main_np, j8, workdir):
    """[midres]: the CLI with --save-midres on the main stack: every
    artifact of pnr_tpu's list, and `_J8.tif` equal to the batch's J8."""
    from pnr_tpu_torch import cli
    from pnr_tpu_torch.io.volume import load_volume

    src = os.path.join(workdir, "midres.npy")
    np.save(src, main_np)
    t0 = time.perf_counter()
    rc = cli.main(["-i", src, "-p", *MAIN_PARAMS, "--device", DEVICE, "--save-midres",
                   "--quiet"])
    wall = time.perf_counter() - t0
    missing = [x for x in MIDRES_SUFFIXES if not os.path.exists(src + x)]
    same_j8 = not missing and np.array_equal(load_volume(src + "_J8.tif"), j8)
    print(f"[midres] CLI --save-midres on {MAIN_SHAPE}: rc {rc}, {wall:.3f} s, "
          f"{len(MIDRES_SUFFIXES) - len(missing)} of {len(MIDRES_SUFFIXES)} artifacts "
          f"(missing {missing}), _J8.tif equal to the run's J8 {same_j8} [{card}]", flush=True)
    check(rc == 0 and not missing and same_j8, "[midres] every artifact, _J8.tif the J8")
    return {"s": wall}


def phase_serving(torch, card, main_np):
    """The serving layer's phases on the main stack's size: [batch exact],
    [batch tube], [serve], [checkpoint], [midres]."""
    t0 = time.perf_counter()
    vols = [main_np] + [make_volume(MAIN_SHAPE, seed=i) for i in range(1, BATCH_STACKS)]
    print(f"[batch] made {BATCH_STACKS - 1} more {MAIN_SHAPE} stacks in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = {}
    out["batch exact"], exact = phase_batch(torch, card, vols, "exact")
    out["batch tube"], _ = phase_batch(torch, card, vols, "tube")
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_serving_", dir=HERE)
    try:
        out["serve"] = phase_serve(torch, card, vols, exact, workdir)
        out["checkpoint"] = phase_checkpoint(torch, card, main_np, workdir)
        out["midres"] = phase_midres(torch, card, main_np, exact[0].j8, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out, vols, exact


#: shards of the virtual mesh of the sharded phases (all on the card)
MESH_SHARDS = 4
#: [sharded 2d]'s plane and [sharded checkpoint]'s stack
SHARDED_PLANE_SHAPE = (1, 2048, 2048)
SHARDED_CK_SHAPE = (32, 256, 256)
#: the kernels each sharded path must launch: the unfused filter's K4 and
#: K3 on every shard's halo slab, then K2 or tube_corr (and the map build
#: on K3)
SHARDED_KERNELS = {
    "exact": ("conv_yx", "conv1d_axis", "exact_sums", "threefry"),
    "tube": ("conv_yx", "conv1d_axis", "conv1d_along_axis", "tube_corr_trace",
             "tube_corr_score", "threefry"),
}


def virtual_mesh(torch, n=MESH_SHARDS):
    """n shards on one device: the card's cuda:0 (or the CPU in a rehearsal)."""
    from pnr_tpu_torch.parallel import Mesh

    return Mesh((torch.device("cuda", 0) if DEVICE == "cuda" else torch.device(DEVICE),) * n)


def tree_rows(tree):
    """A node list as the SWC rows that `read_swc` gives for its file."""
    from pnr_tpu_torch.io.swc import read_swc, save_nodelist

    fd, path = tempfile.mkstemp(suffix=".swc", dir=HERE)
    os.close(fd)
    try:
        save_nodelist(tree, path)
        return read_swc(path)
    finally:
        os.remove(path)


def swc_f1(tree, rows):
    """The port's compare_swc of `tree` against SWC rows (dist 3, as
    tests/test_parallel.py scores sharded against single-device)."""
    from pnr_tpu_torch.utils.swc_compare import compare_swc

    return compare_swc(tree_rows(tree), rows, dist=3.0, resample=1.0)


def phase_sharded_filter(torch, card, main_np):
    """[sharded filter]: frangi3d_sharded on the virtual mesh against the
    monolithic unfused filter on the card, bitwise; K4's and K3's
    launches and the phase's milliseconds."""
    from pnr_tpu_torch.ops.frangi import frangi3d
    from pnr_tpu_torch.parallel import frangi3d_sharded, shard_volume

    mesh = virtual_mesh(torch)
    vs = shard_volume(main_np, mesh)
    frangi3d_sharded(vs, SIGMAS, ZDIST, mesh)  # warm
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    j, jmin, jmax, vx, vy, vz = frangi3d_sharded(vs, SIGMAS, ZDIST, mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n = read_counters()
    want = frangi3d(torch.from_numpy(main_np).to(DEVICE), SIGMAS, ZDIST)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    frangi3d(torch.from_numpy(main_np).to(DEVICE), SIGMAS, ZDIST)
    torch.cuda.synchronize()
    mono_ms = (time.perf_counter() - t1) * 1e3
    same = {k: bool(torch.equal(torch.cat(a), b)) for k, a, b in (
        ("J", j, want[0]), ("Vx", vx, want[3]), ("Vy", vy, want[4]), ("Vz", vz, want[5]))}
    same["Jmin"] = bool(torch.equal(jmin, want[1]))
    same["Jmax"] = bool(torch.equal(jmax, want[2]))
    print(f"[sharded filter] frangi3d_sharded over {MESH_SHARDS} shards of one card on "
          f"{MAIN_SHAPE}, sigmas {SIGMAS}: {ms:.3f} ms (the monolithic filter {mono_ms:.3f} ms); "
          f"K4 {n['conv_yx']}, K3 {n['conv1d_axis']} launches; bitwise the monolithic unfused "
          f"filter {json.dumps(same)} [{card}]", flush=True)
    check(all(same.values()), "[sharded filter] bitwise the monolithic unfused filter")
    check(n["conv_yx"] > 0 and n["conv1d_axis"] > 0, "[sharded filter] launched K4 and K3")
    return {"ms": ms, "monolithic_ms": mono_ms, "K4": n["conv_yx"], "K3": n["conv1d_axis"]}


def phase_sharded_main(torch, card, main_np, mode, single_rows):
    """[sharded exact] / [sharded tube]: reconstruction_func_sharded on the
    main stack over the virtual mesh, on the tracer's two routes in turns
    (`mesh_turns`: each shard's stages replayed as stage graphs, and eager):
    each run bitwise run 1; run 1's stages' seconds, the SWC, the handoffs,
    kept-local and lost traces, kernel launches (set to 0 just before it),
    the peak device bytes against plan_sharded's per-shard estimate, and
    SWC F1 against the single-device CLI run of [main exact]/[main tube]
    (same key) >= 0.85; each route's host calls a tracer step."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.parallel import card_memory_bytes, plan_sharded
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    tag = f"sharded {mode}"
    cfg = dataclasses.replace(PNRConfig.from_cli_params(MAIN_PARAMS), zncc_mode=mode)
    mesh = virtual_mesh(torch)
    plan = plan_sharded(MAIN_SHAPE, cfg, MESH_SHARDS, card_memory_bytes(DEVICE))
    out = {"plan_per_shard_bytes": plan.peak_bytes, "plan_peak_stage": plan.peak_stage}
    turns, res = mesh_turns(torch, card, tag, mode,
                            lambda: reconstruction_func_sharded(main_np, cfg, mesh, verbose=False),
                            "tracing (sharded, staged handoff)")
    score = swc_f1(res.tree, single_rows)
    print(f"[{tag}] run 1: {turns['s']:.3f} s, {len(res.tree) - 1} SWC nodes, seeds "
          f"{res.n_raw_seeds} raw / {len(res.seeds_pos)} selected, {res.trace_count} traces, "
          f"{res.n_handoffs} handoffs, {res.n_kept_local} kept local, {res.n_lost} lost, "
          f"{res.n_requeued} re-queued; F1 against the single-device run {score.f1:.4f} (recall "
          f"{score.recall:.4f}, precision {score.precision:.4f}); peak {turns['peak_bytes']} B, "
          f"{MESH_SHARDS} x the plan's {plan.peak_bytes} B a shard ({plan.peak_stage}) = "
          f"{MESH_SHARDS * plan.peak_bytes} [{card}]", flush=True)
    print(f"[{tag}] stages of run 1 (s): "
          f"{json.dumps({k: round(v, 4) for k, v in res.timings.items()})}", flush=True)
    check(score.f1 >= 0.85, f"[{tag}] SWC F1 against the single-device run >= 0.85")
    check(res.n_handoffs > 0 and res.n_lost == 0 and res.n_requeued == 0,
          f"[{tag}] traces handed off, none lost or re-queued")
    check(MESH_SHARDS * plan.peak_bytes >= turns["peak_bytes"],
          f"[{tag}] {MESH_SHARDS} x the plan's per-shard peak covers the measured peak")
    out.update({"s": turns["s"], "tracing_s": turns["tracing_s"], "nodes": len(res.tree) - 1,
                "traces": res.trace_count, "handoffs": res.n_handoffs,
                "kept_local": res.n_kept_local, "f1": score.f1, "peak_bytes": turns["peak_bytes"],
                "launches": turns["launches"], "profile": turns["profile"]})
    print(f"[{tag}] kernel launches during run 1: {json.dumps(out['launches'])}", flush=True)
    check(all(out["launches"][k] > 0 for k in SHARDED_KERNELS[mode]),
          f"[{tag}] launched {', '.join(SHARDED_KERNELS[mode])}")
    check(out["launches"]["frangi3d_fused"] == 0, f"[{tag}] no K1 (the sharded filter is unfused)")
    return out, res


def phase_sharded_2d(torch, card):
    """[sharded 2d]: a (1, 2048, 2048) plane of make_volume's recipe sharded
    over Y on the virtual mesh, exact mode, against the single-device run:
    J8 equal and SWC F1 >= 0.85."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruction_func, reconstruction_func_sharded

    shape = SHARDED_PLANE_SHAPE
    vol = make_volume(shape)
    cfg = PNRConfig.from_cli_params(PLANE_PARAMS)
    single = reconstruction_func(vol, cfg, verbose=False, device=DEVICE)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    res = reconstruction_func_sharded(vol, cfg, virtual_mesh(torch), verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = read_counters()
    score = swc_f1(res.tree, tree_rows(single.tree))
    same_j8 = bool(np.array_equal(res.j8, single.j8))
    print(f"[sharded 2d] {shape} over {MESH_SHARDS} Y shards, exact: {wall:.3f} s, "
          f"{len(res.tree) - 1} SWC nodes, {res.trace_count} traces, {res.n_handoffs} handoffs, "
          f"{res.n_lost} lost; J8 equal to the single-device run's {same_j8}; F1 against it "
          f"{score.f1:.4f}; K3 {n['conv1d_axis']}, K2 {n['exact_sums']} launches [{card}]",
          flush=True)
    check(same_j8 and score.f1 >= 0.85 and res.n_lost == 0,
          "[sharded 2d] J8 the single-device run's, F1 >= 0.85, no trace lost")
    check(n["conv1d_axis"] > 0 and n["exact_sums"] > 0, "[sharded 2d] launched K3 and K2")
    return {"s": wall, "f1": score.f1, "handoffs": res.n_handoffs, "launches": n}


def phase_sharded_checkpoint(torch, card):
    """[sharded checkpoint]: on a (32, 256, 256) stack over the virtual
    mesh, a run cut by the trace cap with a checkpoint, resumed with the
    cap lifted: bitwise the uninterrupted run."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    vol = make_volume(SHARDED_CK_SHAPE, seed=3)
    cfg = dataclasses.replace(PNRConfig.from_cli_params(MAIN_PARAMS), wave_size=16)
    mesh = virtual_mesh(torch)
    full = reconstruction_func_sharded(vol, cfg, mesh, verbose=False)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_sharded_", dir=HERE)
    try:
        ck = os.path.join(tmp, "cut.npz")
        cap = max(1, full.trace_count // 2)
        part = reconstruction_func_sharded(vol, dataclasses.replace(cfg, max_trace_count=cap),
                                           mesh, verbose=False, checkpoint_path=ck)
        resumed = reconstruction_func_sharded(vol, cfg, mesh, verbose=False, checkpoint_path=ck,
                                              resume=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = same_tree(resumed, full)
    print(f"[sharded checkpoint] {SHARDED_CK_SHAPE}: cut at {part.trace_count} of "
          f"{full.trace_count} traces, resumed: bitwise the uninterrupted run {same} [{card}]",
          flush=True)
    check(0 < part.trace_count < full.trace_count and same,
          "[sharded checkpoint] a cap-cut run resumed is bitwise the uninterrupted run")
    return {"traces": full.trace_count, "cut_at": part.trace_count}


def phase_sharded_cards(torch, card, main_np, virtual_exact):
    """[sharded cards]: with two or more cards, the main stack, exact, over
    min(4, count) real cards: the tree bitwise the virtual mesh's, each
    card's peak under the plan's per-shard estimate. With one card it is
    not run (it needs a second card), and says so."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.parallel import card_memory_bytes, make_mesh, plan_sharded
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    count = torch.cuda.device_count() if DEVICE == "cuda" else 0
    if count < 2:
        print(f"[sharded cards] not run: {count} card(s) here; a mesh of real cards needs two "
              f"or more (peer copies between cards and per-card streams are unverified by this "
              f"run) [{card}]", flush=True)
        return {"run": False, "cards": count}
    n = min(4, count)
    cfg = PNRConfig.from_cli_params(MAIN_PARAMS)
    mesh = make_mesh(n)
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    res = reconstruction_func_sharded(main_np, cfg, mesh, verbose=False)
    for i in range(n):
        torch.cuda.synchronize(i)
    wall = time.perf_counter() - t0
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
    plan = plan_sharded(MAIN_SHAPE, cfg, n, card_memory_bytes(mesh.devices[0]))
    same = same_tree(res, virtual_exact)
    print(f"[sharded cards] the main stack, exact, over {n} cards: {wall:.3f} s, {res.n_handoffs} "
          f"handoffs; bitwise the virtual mesh's tree {same}; peaks {peaks} B against the plan's "
          f"{plan.peak_bytes} B a card [{card}]", flush=True)
    check(same and all(p <= plan.peak_bytes for p in peaks),
          "[sharded cards] bitwise the virtual mesh, each card under its plan")
    return {"run": True, "cards": n, "s": wall, "peaks": peaks}


def phase_plan(torch, card, main_np):
    """[plan]: `--plan --mesh 4` and `--plan` through the CLI on the main
    stack against the card's memory, and min_devices for a 2048^3 exact
    stack."""
    from pnr_tpu_torch import PNRConfig, cli
    from pnr_tpu_torch.parallel import (
        card_memory_bytes,
        frangi_halo,
        min_devices,
        plan_sharded,
        slab_filter_route,
    )

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_plan_", dir=HERE)
    try:
        src = os.path.join(tmp, "stack.npy")
        np.save(src, main_np)
        for extra in (["--mesh", str(MESH_SHARDS)], []):
            print(f"[plan] python -m pnr_tpu_torch -i <{MAIN_SHAPE} stack> --plan "
                  f"{' '.join(extra)}:", flush=True)
            rc = cli.main(["-i", src, "-p", *MAIN_PARAMS, "--plan", "--device", DEVICE, *extra])
            check(rc == 0, f"[plan] --plan {' '.join(extra)} exited {rc} (the stack fits)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mem = card_memory_bytes(DEVICE)
    big = min_devices((2048, 2048, 2048), PNRConfig.from_cli_params(MAIN_PARAMS), mem)
    print(f"[plan] min_devices for a (2048, 2048, 2048) exact stack: {big.n_devices} cards\n"
          f"{big.summary()} [{card}]", flush=True)
    # tests/test_plan.py's stack: the per-shard peak falls over 1, 2, 4, 8
    # cards, each slab taking the route of the lower planned peak
    jax_shape = (512, 1024, 1024)
    falls = {}
    for mode in ("tube", "exact"):
        cfg = dataclasses.replace(PNRConfig.from_cli_params(MAIN_PARAMS), zncc_mode=mode)
        plans = [plan_sharded(jax_shape, cfg, n, mem) for n in (1, 2, 4, 8)]
        gib = [round(p.peak_bytes / (1 << 30), 2) for p in plans]
        falls[mode] = gib
        print(f"[plan] {jax_shape} {mode} over 1, 2, 4, 8 cards: peak {gib} GiB a shard, filter "
              f"routes {[next(k for k in p.stages if k.startswith('frangi')) for p in plans]}",
              flush=True)
        check(all(a > b for a, b in zip(gib, gib[1:])),
              f"[plan] {jax_shape} {mode}: the per-shard peak falls strictly over 1, 2, 4, 8 cards")
    slab = (MAIN_SHAPE[0] // MESH_SHARDS + 2 * frangi_halo(SIGMAS, ZDIST),) + MAIN_SHAPE[1:]
    route = slab_filter_route(slab, SIGMAS, ZDIST)
    print(f"[plan] a four-shard halo slab of the main stack {slab}: "
          f"{'tiled' if route.tiled else 'monolithic'} ({route.peak_bytes} bytes planned)",
          flush=True)
    check(not route.tiled, "[plan] the main stack's four-shard slabs take the monolithic filter")
    return {"min_devices_2048_exact": big.n_devices, "peak_stage": big.peak_stage,
            "jax_shape_peaks_gib": falls}


def phase_sharded(torch, card, main_np, main_rows):
    """The sharded phases, after [serving]."""
    out = {"filter": phase_sharded_filter(torch, card, main_np)}
    torch.cuda.empty_cache()
    virtual = {}
    for mode in ("exact", "tube"):
        out[mode], virtual[mode] = phase_sharded_main(torch, card, main_np, mode, main_rows[mode])
        torch.cuda.empty_cache()
    out["2d"] = phase_sharded_2d(torch, card)
    out["checkpoint"] = phase_sharded_checkpoint(torch, card)
    out["cards"] = phase_sharded_cards(torch, card, main_np, virtual["exact"])
    out["plan"] = phase_plan(torch, card, main_np)
    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "pnr_tpu") or m.startswith(("jax.", "pnr_tpu.")))
    check(not loaded, f"no module of jax or of pnr_tpu was imported (found {loaded})")
    return out, virtual


#: the kernels each batch-over-a-mesh path must launch: the batch's unfused
#: filter (K4 and K3; `frangi2d` on K3 for a plane), then K2 or tube_corr
MESH_PATH_KERNELS = {
    "batch dp exact": ("conv_yx", "conv1d_axis", "exact_sums", "threefry"),
    "batch dp tube": ("conv_yx", "conv1d_axis", "conv1d_along_axis", "tube_corr_trace",
                      "tube_corr_score", "threefry"),
    "batch dp 2d": ("conv1d_axis", "exact_sums", "threefry"),
    "batch sharded": ("conv_yx", "conv1d_axis", "exact_sums", "threefry"),
    "serve sharded": ("conv_yx", "conv1d_axis", "exact_sums", "threefry"),
    "multiprocess": ("conv_yx", "conv1d_axis", "exact_sums", "threefry"),
}
#: [batch sharded]'s stacks (three before its runs came in two routes)
BATCH_SHARDED_STACKS = 2
#: [multiprocess]: two processes, each with this many shards on the card
MP_SHARDS_PER_PROCESS = 2
MP_TIMEOUT_S = 300


def same_run(a, b):
    """JAX's bar for a batch or multi-process run against its reference
    (tests/test_parallel.py, tests/test_multiprocess.py): J8 bitwise, equal
    trace and node counts, node types equal, node positions within 1e-4."""
    return (np.array_equal(a.j8, b.j8) and a.trace_count == b.trace_count
            and len(a.n0) == len(b.n0) and len(a.tree) == len(b.tree)
            and np.array_equal(np.asarray(a.n0.type), np.asarray(b.n0.type))
            and np.allclose(a.n0.positions(), b.n0.positions(), rtol=0.0, atol=1e-4))


def timed(torch, fn):
    """fn()'s result and its seconds, the card synchronised on both sides."""
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_launches(tag, n):
    print(f"[{tag}] kernel launches: {json.dumps(n)}", flush=True)
    check(all(n[k] > 0 for k in MESH_PATH_KERNELS[tag]),
          f"[{tag}] launched {', '.join(MESH_PATH_KERNELS[tag])}")
    check(n["frangi3d_fused"] == 0, f"[{tag}] no K1 (the path's filter is unfused)")


#: the mesh tracers' routes in turns ([batch dp exact], [batch dp tube],
#: [sharded exact], [sharded tube], [batch sharded]): stage graphs (the
#: default) and eager stages; run 1 timed, runs 2 and 3 under the profiler
MESH_ROUTES = ("graphs", "eager", "graphs")


@contextlib.contextmanager
def mesh_route(route):
    """The mesh tracers' trackers (batch DP's, the handoff tracer's) on
    `route`: "graphs" (the default: each stack's or shard's stages replayed
    as CUDA graphs) or "eager" (`BatchedTracker(..., graphs=False)`, the
    A/B switch)."""
    from pnr_tpu_torch.parallel import batch_dp, handoff

    real = (batch_dp.BatchedTracker, handoff.BatchedTracker)
    if route == "eager":
        batch_dp.BatchedTracker = handoff.BatchedTracker = functools.partial(real[0],
                                                                              graphs=False)
    try:
        yield
    finally:
        batch_dp.BatchedTracker, handoff.BatchedTracker = real


def as_list(res):
    return res if isinstance(res, list) else [res]


def mesh_turns(torch, card, tag, mode, run, tracing):
    """`run()` on the routes of MESH_ROUTES in turns: run 1 (graphs) timed,
    with the device's peak bytes over its start; runs 2 (eager) and 3
    (graphs) under the profiler (host launch calls a tracer step, the
    card's busy time a stage). Each run's kernel launches: counts set to 0
    just before it, read just after. Checks: every run's trees, node
    graphs, seeds and trace counts bitwise run 1's; the kernel launches of
    the two routes equal; graph captures and replays on the graph route
    only. Prints each run's seconds, its `tracing` stage (the first
    stack's), captures and replays, and each route's host calls a tracer
    step and busy milliseconds a stage. Returns ({"s", "tracing_s",
    "peak_bytes", "launches", "profile": {route: phase_profile's}}, run
    1's result)."""
    want = ("K4", "tube_corr (K5, K6)" if mode == "tube" else "K2")
    out = {"profile": {}}
    first = None
    for i, route in enumerate(MESH_ROUTES):
        got = []
        with mesh_route(route):
            if i == 0:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                reset_counters()
                res, wall = timed(torch, run)
                out.update(s=wall, tracing_s=as_list(res)[0].timings[tracing],
                           launches=read_counters(),
                           peak_bytes=torch.cuda.max_memory_allocated() - base)
                n = out["launches"]
            else:
                prof = out["profile"][route] = phase_profile(
                    torch, card, mode, lambda: got.append(run()), out["s"],
                    label=f"{tag} {route}", want=want)
                res, wall, n = got[0], prof["wall_s"], prof["launches"]
        print(f"[{tag}] run {i + 1}, {route}{' (profiled)' if i else ''}: {wall:.3f} s, "
              f"{tracing} {as_list(res)[0].timings[tracing]:.4f} s (stack 1); "
              f"{n['graph_captures']} stage graphs captured, {n['graph_replays']} replayed "
              f"[{card}]", flush=True)
        if first is None:
            first = res
        check(all(same_tree(a, b) for a, b in zip(as_list(res), as_list(first)))
              and len(as_list(res)) == len(as_list(first)),
              f"[{tag}] run {i + 1} ({route}): trees, node graphs, seeds and trace counts bitwise "
              f"run 1's")
    g, e = out["launches"], out["profile"]["eager"]["launches"]
    kernels = [k for k in g if not k.startswith("graph_")]
    check(all(g[k] == e[k] for k in kernels),
          f"[{tag}] the graph route's kernel launches are the eager route's")
    check(g["graph_captures"] > 0 and g["graph_replays"] > 0 and e["graph_captures"] == 0
          and e["graph_replays"] == 0,
          f"[{tag}] stage graphs captured and replayed on the graph route only")
    pe, pg = out["profile"]["eager"], out["profile"]["graphs"]
    print(f"[{tag}] eager / graphs, profiled: host launch calls a tracer step "
          f"{pe['host_calls_per_step']:.1f} / {pg['host_calls_per_step']:.1f}; the card busy "
          f"{pe['busy_ms'] / pe['stages']:.3f} / {pg['busy_ms'] / pg['stages']:.3f} ms a stage "
          f"({pe['stages']} / {pg['stages']} stages), idle {pe['idle']:.4f} / {pg['idle']:.4f}"
          f" [{card}]", flush=True)
    return out, first


def phase_batch_dp(torch, card, vols, mode, k1_results=None):
    """[batch dp exact] / [batch dp tube] / [batch dp 2d]: the stacks through
    `reconstruction_batch_dp` on a virtual mesh of one shard a stack on the
    card, then through `reconstruction_batch` with `fused_frangi=False`,
    prefetch on and off: each stack at JAX's bar against the one-by-one run
    (and whether the trees are bitwise too); seconds per stack of the
    three. Exact and tube run batch DP on the tracer's two routes in turns
    (`mesh_turns`: each stack's lockstep stages replayed as stage graphs,
    and eager), the 2-D planes once on the graph route (launch counts set to
    0 just before, read just after). With `k1_results` (the default
    config's batch, K1), the J8 differences from it, as information."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.parallel import reconstruction_batch_dp
    from pnr_tpu_torch.pipeline import reconstruction_batch

    tag = f"batch dp {mode}"
    plane = mode == "2d"
    cfg = dataclasses.replace(PNRConfig.from_cli_params(PLANE_PARAMS if plane else MAIN_PARAMS),
                              zncc_mode="exact" if plane else mode, fused_frangi=False)
    mesh = virtual_mesh(torch, len(vols))
    n = len(vols)
    out = {}
    if plane:
        reset_counters()
        dp, dp_s = timed(torch, lambda: reconstruction_batch_dp(vols, cfg, mesh, device=DEVICE))
        launches = read_counters()
    else:
        turns, dp = mesh_turns(torch, card, tag, mode,
                               lambda: reconstruction_batch_dp(vols, cfg, mesh, device=DEVICE),
                               "tracing (batch, lockstep waves)")
        launches, dp_s = turns["launches"], turns["s"]
        out.update(tracing_s=turns["tracing_s"], profile=turns["profile"])
    on, on_s = timed(torch, lambda: list(reconstruction_batch(vols, cfg, prefetch=True,
                                                              device=DEVICE)))
    off, off_s = timed(torch, lambda: list(reconstruction_batch(vols, cfg, prefetch=False,
                                                                device=DEVICE)))
    same = [same_run(a, b) for a, b in zip(dp, off)]
    bitwise = [same_tree(a, b) for a, b in zip(dp, off)]
    print(f"[{tag}] {n} {tuple(vols[0].shape)} stacks, one a shard of a virtual mesh: "
          f"{dp_s:.3f} s ({dp_s / n:.4f} s a stack); reconstruction_batch (fused_frangi=False) "
          f"prefetch on {on_s:.3f} s ({on_s / n:.4f}), off {off_s:.3f} s ({off_s / n:.4f}); "
          f"each stack at JAX's bar against the one-by-one run {same}, trees bitwise {bitwise}; "
          f"traces {[r.trace_count for r in dp]}, SWC nodes {[len(r.tree) - 1 for r in dp]}; "
          f"{launches['graph_captures']} stage graphs captured, {launches['graph_replays']} "
          f"replayed [{card}]", flush=True)
    print(f"[{tag}] stages of stack 1 (s): "
          f"{json.dumps({k: round(v, 4) for k, v in dp[0].timings.items()})}", flush=True)
    check(all(same) and len(dp) == n, f"[{tag}] every stack at JAX's bar against the one-by-one run")
    mesh_launches(tag, launches)
    check(launches["graph_replays"] > 0, f"[{tag}] the lockstep stages replayed as stage graphs")
    out.update({"s_per_stack": dp_s / n, "batch_prefetch_s_per_stack": on_s / n,
                "batch_one_by_one_s_per_stack": off_s / n, "bitwise": all(bitwise),
                "launches": launches})
    if k1_results is not None:
        diff = [int((a.j8 != b.j8).sum()) for a, b in zip(dp, k1_results)]
        dmax = [int(np.abs(a.j8.astype(np.int16) - b.j8.astype(np.int16)).max())
                for a, b in zip(dp, k1_results)]
        print(f"[{tag}] information: J8 of the batch (unfused filter) against the default "
              f"config's batch (K1): voxels that differ {diff} of {vols[0].size}, max |diff| "
              f"{dmax}", flush=True)
        out["j8_vs_k1"] = {"voxels": diff, "max_abs": dmax}
    return out


def phase_batch_sharded(torch, card, vols):
    """[batch sharded]: the stacks through `reconstruction_batch_sharded`,
    two groups of two shards of a virtual mesh of four, exact, on the
    tracer's two routes in turns (`mesh_turns`; on the graph route the two
    group threads capture their shards' stage graphs on the card at once):
    each stack at JAX's bar against `reconstruction_func_sharded` on a
    two-shard mesh."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.parallel import reconstruction_batch_sharded
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    cfg = PNRConfig.from_cli_params(MAIN_PARAMS)
    mesh, sub = virtual_mesh(torch, 4), virtual_mesh(torch, 2)
    turns, got = mesh_turns(torch, card, "batch sharded", "exact",
                            lambda: reconstruction_batch_sharded(vols, cfg, mesh, groups=2),
                            "tracing (sharded, staged handoff)")
    launches, s = turns["launches"], turns["s"]
    refs, ref_s = timed(torch, lambda: [reconstruction_func_sharded(v, cfg, sub, verbose=False)
                                        for v in vols])
    same = [same_run(a, b) for a, b in zip(got, refs)]
    bitwise = [same_tree(a, b) for a, b in zip(got, refs)]
    n = len(vols)
    print(f"[batch sharded] {n} {MAIN_SHAPE} stacks, two groups of two shards on the card: "
          f"{s:.3f} s ({s / n:.4f} s a stack); one by one on a two-shard mesh {ref_s:.3f} s "
          f"({ref_s / n:.4f}); each at JAX's bar against it {same}, trees bitwise {bitwise}; "
          f"handoffs {[r.n_handoffs for r in got]} [{card}]", flush=True)
    check(all(same), "[batch sharded] every stack at JAX's bar against the two-shard run")
    mesh_launches("batch sharded", launches)
    return {"s_per_stack": s / n, "one_by_one_s_per_stack": ref_s / n, "bitwise": all(bitwise),
            "launches": launches, "tracing_s": turns["tracing_s"], "profile": turns["profile"]}


def phase_serve_sharded(torch, card, vols, workdir):
    """[serve sharded]: two stacks served through the CLI's `--watch --mesh
    2` (the CLI's `make_mesh` given a virtual mesh of two shards on the card,
    which has one): two arrivals split the mesh into two one-shard groups;
    each SWC as `reconstruction_func_sharded` on a one-shard mesh writes it."""
    from pnr_tpu_torch import PNRConfig, cli, parallel
    from pnr_tpu_torch.io.swc import read_swc
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    d = os.path.join(workdir, "watch_mesh")
    os.makedirs(d)
    names = [f"s{i}.npy" for i in range(len(vols))]
    for name, vol in zip(names, vols):
        np.save(os.path.join(d, name), vol)
    open(os.path.join(d, ".stop"), "w").close()
    make = parallel.make_mesh
    parallel.make_mesh = lambda n, axis="z", device="cuda": virtual_mesh(torch, n)
    reset_counters()
    try:
        rc, s = timed(torch, lambda: cli.main(["-i", d, "-p", *MAIN_PARAMS, "--watch", "--mesh",
                                               "2", "--device", DEVICE, "--quiet"]))
    finally:
        parallel.make_mesh = make
    launches = read_counters()
    cfg = PNRConfig.from_cli_params(MAIN_PARAMS)
    same = []
    for name, vol in zip(names, vols):
        out = os.path.join(d, name + "_Advantra.swc")
        ref = reconstruction_func_sharded(vol, cfg, virtual_mesh(torch, 1), verbose=False)
        same.append(os.path.exists(out) and np.array_equal(read_swc(out), tree_rows(ref.tree)))
    print(f"[serve sharded] --watch --mesh 2 (two shards of the card): rc {rc}, {s:.3f} s for "
          f"{len(vols)} stacks; each SWC the one-shard sharded run's {same} [{card}]", flush=True)
    check(rc == 0 and all(same), "[serve sharded] each SWC the one-shard sharded run's")
    mesh_launches("serve sharded", launches)
    return {"s": s, "launches": launches}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_multiprocess(torch, card, main_np, ref, single_s, workdir):
    """[multiprocess]: the main stack, exact, through
    `reconstruction_func_sharded` in two processes of a gloo group
    (`init_multihost`), each with two shards on the card (this script with
    --mp-child, `make_global_mesh`), twice: against the single-process
    four-shard run `ref`, J8 and node types bitwise, node coordinates
    within 1e-4, equal trace counts; the seconds of each run beside the
    single-process run's (`single_s`), the bytes each stage received from
    the other process, and run 1's launches of both processes (set to 0
    just before it in each)."""
    np.save(os.path.join(workdir, "mp_stack.npy"), main_np)
    with open(os.path.join(workdir, "mp_params.json"), "w") as f:
        json.dump(MAIN_PARAMS, f)
    port = str(_free_port())
    dev = "cuda:0" if DEVICE == "cuda" else DEVICE
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-child", str(r),
                               port, workdir, dev],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=HERE)
             for r in range(2)]
    outs = []
    t0 = time.perf_counter()
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        print(f"[multiprocess] rank {r} exited {p.returncode}; its output's end:\n"
              f"{out[-1500:].rstrip()}", flush=True)
        check(p.returncode == 0, f"[multiprocess] rank {r} exited 0")
    info = [json.load(open(os.path.join(workdir, f"mp_rank{r}.json"))) for r in range(2)]
    got = np.load(os.path.join(workdir, "mp_result.npz"))
    same = {
        "j8": bool(np.array_equal(got["j8"], ref.j8)),
        "types": bool(np.array_equal(got["ntype"], np.asarray(ref.n0.type))),
        "traces": int(got["trace_count"]) == ref.trace_count,
        "tree": int(got["tree_n"]) == len(ref.tree),
        "coords": len(got["x"]) == len(ref.n0) and all(
            np.allclose(got[k], np.asarray(getattr(ref.n0, k)), rtol=0.0, atol=1e-4)
            for k in ("x", "y", "z", "sig")),
    }
    launches = {k: info[0]["launches"][k] + info[1]["launches"][k] for k in info[0]["launches"]}
    print(f"[multiprocess] the main stack, exact, two processes x {MP_SHARDS_PER_PROCESS} shards "
          f"on one card (gloo): run seconds rank 0 {info[0]['s']}, rank 1 {info[1]['s']} (the "
          f"single-process four-shard run: {[round(x, 4) for x in single_s]}); {wall:.3f} s with "
          f"both processes' start; against the single-process four-shard run: "
          f"{json.dumps(same)} [{card}]", flush=True)
    for r in range(2):
        print(f"[multiprocess] rank {r} run 1 bytes received per stage: "
              f"{json.dumps(info[r]['received'])}; stages (s): {json.dumps(info[r]['stages'])}",
              flush=True)
    check(all(same.values()), "[multiprocess] equal to the single-process four-shard run")
    mesh_launches("multiprocess", launches)
    return {"s": [info[0]["s"], info[1]["s"]], "received": [i["received"] for i in info],
            "launches": launches, "wall_s": wall}


def mp_child(rank: int, port: str, workdir: str, device: str) -> int:
    """One process of [multiprocess] (run as `chip_smoke.py --mp-child RANK
    PORT WORKDIR DEVICE`)."""
    import torch

    sys.path.insert(0, HERE)
    global DEVICE
    DEVICE = "cuda" if device.startswith("cuda") else device
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.parallel import init_multihost, make_global_mesh, shutdown_multihost
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    init_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        mesh = make_global_mesh(device=(device,) * MP_SHARDS_PER_PROCESS)
        check(mesh.multiprocess and mesh.size == 2 * MP_SHARDS_PER_PROCESS,
              f"a global mesh of {2 * MP_SHARDS_PER_PROCESS} shards over two processes")
        vol = np.load(os.path.join(workdir, "mp_stack.npy"))
        cfg = PNRConfig.from_cli_params(json.load(open(os.path.join(workdir, "mp_params.json"))))
        secs = []
        for run in (1, 2):
            if run == 1:
                reset_counters()
            res, s = timed(torch, lambda: reconstruction_func_sharded(vol, cfg, mesh,
                                                                       verbose=False))
            secs.append(round(s, 4))
            if run == 1:
                launches, first = read_counters(), res
        print(f"rank {rank}: runs {secs} s, {first.trace_count} traces, {first.n_handoffs} "
              f"handoffs", flush=True)
        with open(os.path.join(workdir, f"mp_rank{rank}.json"), "w") as f:
            json.dump({"s": secs, "launches": launches, "received": first.received_bytes,
                       "stages": {k: round(v, 4) for k, v in first.timings.items()}}, f)
        if rank == 0:
            np.savez(os.path.join(workdir, "mp_result.npz"), j8=first.j8,
                     ntype=np.asarray(first.n0.type), x=np.asarray(first.n0.x),
                     y=np.asarray(first.n0.y), z=np.asarray(first.n0.z),
                     sig=np.asarray(first.n0.sig), trace_count=first.trace_count,
                     tree_n=len(first.tree))
    finally:
        shutdown_multihost()
    return 0


def phase_mesh(torch, card, vols, k1_exact, virtual_exact, single_s, main_np):
    """The batch-over-a-mesh and multi-process phases, after [sharded]."""
    out = {}
    for mode in ("exact", "tube"):
        out[f"batch dp {mode}"] = phase_batch_dp(torch, card, vols, mode,
                                                 k1_exact if mode == "exact" else None)
        torch.cuda.empty_cache()
    planes = [make_volume(PLANE_SHAPE, seed=i) for i in range(2)]
    out["batch dp 2d"] = phase_batch_dp(torch, card, planes, "2d")
    del planes
    torch.cuda.empty_cache()
    out["batch sharded"] = phase_batch_sharded(torch, card, vols[:BATCH_SHARDED_STACKS])
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_mesh_", dir=HERE)
    try:
        out["serve sharded"] = phase_serve_sharded(torch, card, vols[:2], workdir)
        torch.cuda.empty_cache()
        out["multiprocess"] = phase_multiprocess(torch, card, main_np, virtual_exact, single_s,
                                                 workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


#: [sharded step]: seeds a wave of the full library step (ceil(wave / 4)
#: a shard, in 2 x that + 2 lanes)
STEP_WAVE = 64
#: [alt]: the J8 voxels the alternate extractor takes as candidates
ALT_CANDIDATES = 20_000
#: [host]: the stack the CLI and the host engine each run in a fresh
#: process (4.2 Mvox, under the 8 Mvox of JAX's automatic host route)
HOST_SHAPE = (64, 256, 256)
HOST_TIMEOUT_S = 300


def flood_divergence(card_mask, native_mask):
    """JAX's bound of the device flood against the sequential one
    (tests/test_seeds.py TestAdversarialFlood): per slice equal counts; the
    share of seeds at the same voxel; the largest distance of a seed of
    either set from the nearest of the other, per slice."""
    same = total = 0
    far = 0.0
    counts_equal = True
    for z in range(card_mask.shape[0]):
        a, b = np.argwhere(card_mask[z]), np.argwhere(native_mask[z])
        counts_equal &= len(a) == len(b)
        total += len(b)
        if not len(a) or not len(b):
            far = max(far, 0.0 if len(a) == len(b) else float("inf"))
            continue
        d = np.linalg.norm(a[:, None].astype(float) - b[None].astype(float), axis=-1)
        far = max(far, float(d.min(axis=1).max()), float(d.min(axis=0).max()))
        same += len({tuple(p) for p in a} & {tuple(p) for p in b})
    return counts_equal, (same / total if total else 1.0), far


def phase_flood(torch, card, main_np):
    """[flood]: the device seed flood (`max_points_device`, JAX's label
    propagation as torch ops) on the card on the main exact path's J8 (K1
    then normalize_to_u8) against the native sequential flood: equal seed
    counts per slice, >= 95% of positions exact, every divergent seed within
    2 px (JAX's bound); the card's mask on a crop bitwise the port's CPU run
    of the same function; both floods timed. Returns the card's mask."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.ops.frangi import normalize_to_u8
    from pnr_tpu_torch.pipeline.reconstruct import _frangi
    from pnr_tpu_torch.seeds.extract import max_points_device, max_points_host

    cfg = PNRConfig.from_cli_params(MAIN_PARAMS)
    vol = torch.from_numpy(main_np).to(DEVICE)
    j, jmin, jmax, _, _, _ = _frangi(vol, cfg)
    j8 = normalize_to_u8(j, jmin, jmax)
    del j, vol
    j8_np = j8.cpu().numpy()
    max_points_device(j8[:2], cfg.tolerance)  # warm-up
    mask, card_s = timed(torch, lambda: max_points_device(j8, cfg.tolerance))
    mask = mask.cpu().numpy()
    native_mask, native_s = timed(torch, lambda: max_points_host(j8_np, cfg.tolerance))
    counts_equal, exact, far = flood_divergence(mask, native_mask)
    # eight planes of the tube's middle, 240 x 240
    c = min(120, MAIN_SHAPE[1] // 2, MAIN_SHAPE[2] // 2)
    zc, yc, xc = (d // 2 for d in MAIN_SHAPE)
    crop = j8[max(0, zc - 4):zc + 4, yc - c:yc + c, xc - c:xc + c]
    cpu_crop = max_points_device(crop.cpu(), cfg.tolerance)
    card_crop = max_points_device(crop, cfg.tolerance).cpu()
    out = {"card_s": card_s, "native_s": native_s, "seeds": int(mask.sum()),
           "native_seeds": int(native_mask.sum()), "exact_share": exact, "max_px": far,
           "crop_seeds": int(cpu_crop.sum())}
    print(f"[flood] card {card_s:.4f} s, native {native_s:.4f} s on the {MAIN_SHAPE} J8; seeds "
          f"{out['seeds']} (native {out['native_seeds']}), same voxel {exact:.4f}, farthest "
          f"{far:.3f} px; crop {tuple(crop.shape)} {out['crop_seeds']} seeds [{card}]", flush=True)
    check(counts_equal, "[flood] equal seed counts per slice")
    check(exact >= 0.95, "[flood] at least 95% of the seeds at the native flood's voxels")
    check(far <= 2.0, "[flood] every divergent seed within 2 px of the native flood's")
    check(out["crop_seeds"] > 0, "[flood] the crop holds seeds")
    check(torch.equal(card_crop, cpu_crop), "[flood] the card's crop bitwise the CPU run")
    return out, mask, j8_np


def phase_no_native(torch, card, main_np, flood_mask):
    """[no-native]: one exact run of the main path (`reconstruction_func`,
    K1) with `native.have_native` forced False, as on a machine where g++
    failed: the seeds come from the card's flood (its calls counted, the
    native floods refused) and equal [flood]'s mask."""
    from pnr_tpu_torch import PNRConfig, native
    from pnr_tpu_torch.pipeline import reconstruction_func
    from pnr_tpu_torch.seeds import extract

    cfg = PNRConfig.from_cli_params(MAIN_PARAMS)
    calls, masks = [], []
    real = (native.have_native, extract.max_points_device, native.max_finder_stack,
            native.max_finder_2d)

    def counted(*a, **k):
        m = real[1](*a, **k)
        calls.append(m.device.type)
        masks.append(m.cpu().numpy())
        return m

    def refused(*a, **k):
        raise RuntimeError("the native flood ran on the no-native route")

    native.have_native = lambda: False
    extract.max_points_device = counted
    native.max_finder_stack = native.max_finder_2d = refused
    try:
        reset_counters()
        res, wall = timed(torch, lambda: reconstruction_func(main_np, cfg, verbose=False,
                                                             device=DEVICE))
        n = read_counters()
    finally:
        (native.have_native, extract.max_points_device, native.max_finder_stack,
         native.max_finder_2d) = real
    print(f"[no-native] {wall:.3f} s, {len(res.tree) - 1} SWC nodes, {res.n_raw_seeds} raw "
          f"seeds, the device flood called {len(calls)} time(s) on {calls}; stages (s) "
          f"{json.dumps({k: round(v, 4) for k, v in res.timings.items()})}; launches "
          f"{json.dumps(n)} [{card}]", flush=True)
    check(calls == [torch.device(DEVICE).type], "[no-native] one device flood, on the card")
    check(np.array_equal(masks[0], flood_mask), "[no-native] the seeds are [flood]'s mask")
    check(res.n_raw_seeds == int(flood_mask.sum()) and len(res.tree) > 10,
          "[no-native] the run took those seeds and traced")
    check(all(n[k] > 0 for k in PATH_KERNELS["exact"]), "[no-native] launched K1, K2 and threefry")
    return {"s": wall, "stages": res.timings, "launches": n}


def phase_sharded_step(torch, card, main_np, sharded_j8):
    """[sharded step], [trace_wave]: `build_sharded_step` (filter, J8,
    seeds_sharded, one handed-off wave of four-iteration stages) on the
    main stack over the virtual mesh, exact and tube, launches set to 0
    just before and read just after: its J8 bitwise the sharded pipeline's;
    each shard's seeds the strongest of the card flood of the step's J8 in
    its planes (ties in voxel order); the stitched traces bitwise
    `trace_wave` on the whole stack's field with the same ids and key; then
    `trace_wave` staged bitwise unstaged (its launches counted too)."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.hostpath import threefry as tf
    from pnr_tpu_torch.parallel import (build_sharded_step, frangi3d_sharded,
                                        normalize_to_u8_sharded, seeds_sharded, shard_volume,
                                        stitch_estimates)
    from pnr_tpu_torch.seeds.extract import max_points_device
    from pnr_tpu_torch.smc.tracker import BatchedTracker

    mesh = virtual_mesh(torch)
    n = MESH_SHARDS
    per = -(-STEP_WAVE // n)
    lanes = 2 * per + 2
    zl = MAIN_SHAPE[0] // n
    key = tf.key_from_seed(0)
    out = {}
    for mode in ("exact", "tube"):
        tag = f"sharded step {mode}"
        cfg = dataclasses.replace(PNRConfig.from_cli_params(MAIN_PARAMS), zncc_mode=mode)
        step = build_sharded_step(cfg, mesh, wave=STEP_WAVE)
        vs = shard_volume(main_np, mesh)
        reset_counters()
        res, wall = timed(torch, lambda: step(vs, key))
        launches = read_counters()
        j8 = torch.cat(res["j8"])
        check(np.array_equal(j8.cpu().numpy(), sharded_j8), f"[{tag}] J8 bitwise the sharded pipeline's")
        mask = max_points_device(j8, cfg.tolerance).cpu().numpy()
        j8_np = j8.cpu().numpy()
        for s in range(n):
            zz, yy, xx = np.nonzero(mask[s * zl:(s + 1) * zl])
            score = j8_np[s * zl:(s + 1) * zl][zz, yy, xx].astype(np.int64)
            top = np.lexsort((np.arange(len(score)), -score))[:per]
            want = np.stack([xx[top], yy[top], zz[top] + s * zl], -1).astype(np.float32)
            check(np.array_equal(res["seed_pos"][s * per:s * per + len(top)], want)
                  and int(res["seeds_found"][s]) == len(zz),
                  f"[{tag}] shard {s}'s seeds the strongest {per} of the card flood of its planes")
        j, jmin, jmax, vx, vy, vz = frangi3d_sharded(vs, cfg.sigmas, cfg.zdist, mesh)
        dirs = seeds_sharded(normalize_to_u8_sharded(j, jmin, jmax), vx, vy, vz, cfg.tolerance,
                             mesh, per)[1]
        del j, vx, vy, vz
        est, ids = stitch_estimates(res["est_packs"], res["est_ids"], cfg.ni)
        rows = [divmod(int(t), lanes) for t in ids]
        sp = np.stack([res["seed_pos"][s * per + i] for s, i in rows])
        sd = np.stack([dirs[s * per + i] for s, i in rows])
        tracker = BatchedTracker(cfg, DEVICE)
        field = tracker.prepare_field(torch.from_numpy(main_np).to(DEVICE))
        reset_counters()
        ref, wave_s = timed(torch, lambda: tracker.trace_wave(field, sp, sd, key, ids))
        wave_launches = read_counters()
        unstaged, unstaged_s = timed(torch, lambda: tracker.trace_wave(field, sp, sd, key, ids,
                                                                       staged=False))
        ok = est[:, :, 8] > 0.5
        handed = int(sum(len({(np.nonzero(r == t)[0][0] // lanes) for r in res["est_ids"]
                              if (r == t).any()}) > 1 for t in ids))
        print(f"[{tag}] {wall:.3f} s: {len(ids)} traces ({handed} on two or more shards), "
              f"{int(ok.sum())} valid estimates, seeds found {res['seeds_found'].tolist()}; "
              f"launches {json.dumps(launches)} [{card}]", flush=True)
        print(f"[trace_wave {mode}] staged {wave_s:.3f} s, unstaged {unstaged_s:.3f} s, "
              f"{len(ids)} traces; launches (staged) {json.dumps(wave_launches)} [{card}]",
              flush=True)
        check(ok.sum() > len(ids), f"[{tag}] the wave traced")
        check(np.array_equal(ok, ref.valid) and np.array_equal(est[ok][:, :3], ref.pos[ok])
              and np.array_equal(est[ok][:, 3:6], ref.dir[ok])
              and np.array_equal(est[ok][:, 6], ref.sig[ok])
              and np.array_equal(est[ok][:, 7], ref.corr[ok]),
              f"[{tag}] the stitched traces bitwise trace_wave on the whole stack")
        check(all(np.array_equal(getattr(ref, f), getattr(unstaged, f))
                  for f in ("pos", "dir", "sig", "corr", "valid")),
              f"[trace_wave {mode}] staged bitwise unstaged")
        want = (("conv_yx", "conv1d_axis", "exact_sums", "threefry") if mode == "exact" else
                ("conv_yx", "conv1d_axis", "tube_corr_trace", "threefry"))
        check(all(launches[k] > 0 for k in want) and launches["frangi3d_fused"] == 0,
              f"[{tag}] launched {', '.join(want)} and no K1")
        wave_k = "exact_sums" if mode == "exact" else "tube_corr_trace"
        check(wave_launches[wave_k] > 0 and wave_launches["threefry"] > 0,
              f"[trace_wave {mode}] launched {wave_k} and threefry")
        out[mode] = {"s": wall, "traces": len(ids), "handed_off": handed, "launches": launches,
                     "trace_wave": {"staged_s": wave_s, "unstaged_s": unstaged_s,
                                    "launches": wave_launches}}
        del field, tracker, vs, res
        torch.cuda.empty_cache()
    return out


def phase_alt(torch, card, main_np):
    """[alt]: `extract3d_alt` on the main stack, on the card, its candidates
    the ALT_CANDIDATES strongest J8 voxels: `frangi3d_with_scale` (the
    unfused per-scale filter: K4 and K3 launches counted) with J bitwise the
    port's `frangi3d` J, and seeds on the tube axis, their ZNCC above 0.5,
    sorted by score."""
    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.ops.frangi import frangi3d, normalize_to_u8
    from pnr_tpu_torch.seeds.alt import extract3d_alt, frangi3d_with_scale

    cfg = PNRConfig.from_cli_params(MAIN_PARAMS)
    vol = torch.from_numpy(main_np).to(DEVICE)
    reset_counters()
    (j, _, _, _, sc), filt_s = timed(torch, lambda: frangi3d_with_scale(vol, SIGMAS, ZDIST))
    n_filter = read_counters()
    same_j = torch.equal(j, frangi3d(vol, SIGMAS, ZDIST)[0])
    scales = torch.bincount(sc.reshape(-1).long(), minlength=len(SIGMAS)).tolist()
    hist = torch.bincount(normalize_to_u8(j, j.min(), j.max()).reshape(-1).long(), minlength=256)
    above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])  # voxels >= value
    thr = int(torch.nonzero(above <= ALT_CANDIDATES)[0, 0]) - 1
    del j, sc, vol
    reset_counters()
    (pos, dirs, score, corr), alt_s = timed(
        torch, lambda: extract3d_alt(main_np, cfg, j8_threshold=thr, device=DEVICE))
    n = read_counters()
    print(f"[alt] frangi3d_with_scale {filt_s:.3f} s (launches {json.dumps(n_filter)}), voxels a "
          f"scale {scales}; extract3d_alt {alt_s:.3f} s at J8 > {thr}: {len(pos)} seeds, median y "
          f"{np.median(pos[:, 1]) if len(pos) else float('nan'):.2f}; launches {json.dumps(n)} "
          f"[{card}]", flush=True)
    check(same_j, "[alt] frangi3d_with_scale's J bitwise frangi3d's")
    check(n_filter["conv_yx"] == len(SIGMAS) and n_filter["conv1d_axis"] == 10 * len(SIGMAS),
          "[alt] one K4 and ten K3 launches a scale")
    check(n["conv_yx"] == len(SIGMAS) and n["conv1d_axis"] == 10 * len(SIGMAS)
          and n["frangi3d_fused"] == 0, "[alt] extract3d_alt launched K4 and K3, no K1")
    check(len(pos) > 0 and abs(np.median(pos[:, 1]) - MAIN_SHAPE[1] / 2) <= 3
          and bool((corr > 0.5).all()) and bool((np.diff(score) <= 1e-6).all()),
          "[alt] seeds on the tube axis, ZNCC above 0.5, sorted by score")
    return {"filter_s": filt_s, "s": alt_s, "threshold": thr, "seeds": len(pos), "launches": n}


def phase_host(torch, card, workdir):
    """[host]: the port's CLI (`--device cuda`) and the host one-shot engine
    (`PNR_TPU_HOST_PATH=1`) on one HOST_SHAPE stack, each in a fresh
    process, exact and tube: both SWCs on the tube axis; the wall seconds
    of each process, interpreter start included."""
    src = os.path.join(workdir, "host.npy")
    np.save(src, make_volume(HOST_SHAPE))
    env = {k: v for k, v in os.environ.items() if k != "PNR_TPU_HOST_PATH"}
    env["PYTHONPATH"] = HERE
    out = {}
    for mode in ("exact", "tube"):
        for route in ("cuda", "host"):
            swc = os.path.join(workdir, f"host_{mode}_{route}.swc")
            argv = [sys.executable, "-m", "pnr_tpu_torch", "-i", src, "-p", *MAIN_PARAMS,
                    "--zncc-mode", mode, "-o", swc, "--quiet"]
            run_env = dict(env)
            if route == "cuda":
                argv += ["--device", DEVICE]
            else:
                run_env["PNR_TPU_HOST_PATH"] = "1"
            t0 = time.perf_counter()
            p = subprocess.run(argv, cwd=HERE, env=run_env, capture_output=True, text=True,
                               timeout=HOST_TIMEOUT_S)
            wall = time.perf_counter() - t0
            check(p.returncode == 0, f"[host] {route} {mode} exited {p.returncode}: {p.stderr[-2000:]}")
            rows = np.loadtxt(swc, comments="#", ndmin=2)
            check(len(rows) > 10 and abs(np.median(rows[:, 3]) - HOST_SHAPE[1] / 2) <= 3,
                  f"[host] {route} {mode}: the SWC lies on the tube axis")
            out[f"{mode} {route}"] = {"s": wall, "nodes": len(rows)}
        print(f"[host] {HOST_SHAPE} {mode}: the CLI on the card {out[f'{mode} cuda']['s']:.3f} s "
              f"({out[f'{mode} cuda']['nodes']} nodes), the host engine "
              f"{out[f'{mode} host']['s']:.3f} s ({out[f'{mode} host']['nodes']} nodes), fresh "
              f"processes [{card}]", flush=True)
    return out


def phase_rest(torch, card, main_np, sharded_j8):
    """The phases of the rest of the port: [flood], [no-native], [sharded
    step] with [trace_wave], [alt], [host]."""
    t0 = time.perf_counter()
    out = {}
    out["flood"], mask, _ = phase_flood(torch, card, main_np)
    torch.cuda.empty_cache()
    out["no-native"] = phase_no_native(torch, card, main_np, mask)
    torch.cuda.empty_cache()
    out["sharded step"] = phase_sharded_step(torch, card, main_np, sharded_j8)
    out["alt"] = phase_alt(torch, card, main_np)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_host_", dir=HERE)
    try:
        out["host"] = phase_host(torch, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[rest] {time.perf_counter() - t0:.3f} s for [flood] .. [host] [{card}]", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "pnr_tpu_torch")):
        print("chip_smoke: run from the root of a pnr-tpu checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from pnr_tpu_torch import PNRConfig, cli
    from pnr_tpu_torch.pipeline import reconstruction_func

    t_start = time.perf_counter()
    card = phase_device(torch)
    probe_launches, k7 = phase_build(torch, card)
    t0 = time.perf_counter()
    main_np = make_volume(MAIN_SHAPE)
    print(f"[main] built the {MAIN_SHAPE} stack in {time.perf_counter() - t0:.3f} s", flush=True)
    main_vol = torch.from_numpy(main_np).to(DEVICE)
    k1 = phase_k1(torch, card, main_vol)
    k3, k4 = phase_k3_k4(torch, card, main_vol)
    unfused = phase_unfused(torch, card, main_vol)
    k2 = phase_k2(torch, card, main_vol)
    field, maps = phase_maps(torch, card, main_vol)
    k5, k6 = phase_tube_corr(torch, card, field)
    draws = phase_threefry(torch, card)
    del main_vol, field
    phase_bf16(torch)
    torch.cuda.empty_cache()
    # the 2-D kernels' routes on the 2-D main plane
    plane_np = make_volume(PLANE_SHAPE)
    plane_vol = torch.from_numpy(plane_np).to(DEVICE)
    k2_2d = phase_k2_2d(torch, card, plane_vol)
    field_2d, maps_2d = phase_maps_2d(torch, card, plane_vol)
    k5_2d, k6_2d = phase_tube_corr_2d(torch, card, field_2d)
    del plane_vol, field_2d
    torch.cuda.empty_cache()
    soma_np = make_soma_volume(MAIN_SHAPE)
    soma = phase_soma(torch, card, soma_np)
    launches, profiles, stages, main_rows = {}, {}, {}, {}
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
    try:
        src = os.path.join(workdir, "stack.npy")
        np.save(src, main_np)
        for mode in ("exact", "tube"):
            launches[mode], run2_s, main_rows[mode] = phase_main(torch, card, src, workdir,
                                                                 mode)

            def run(mode=mode):
                rc = cli.main(cli_argv(src, workdir, f"{mode}3", mode))
                check(rc == 0, f"profiled {mode} CLI run exited {rc}")

            profiles[mode] = phase_profile(torch, card, mode, run, run2_s)
        graph_phases = {mode: phase_graphs(torch, card, main_np, mode) for mode in ("exact", "tube")}
        # the soma path: the CLI on the soma stack, exact mode
        soma_src = os.path.join(workdir, "soma.npy")
        np.save(soma_src, soma_np)
        launches["soma"], _, rows = phase_main(torch, card, soma_src, workdir, "exact", "soma",
                                               params=SOMA_PARAMS, runs=(1,))
        n_soma = int((rows[:, 1] == 1).sum())
        print(f"[main soma] {n_soma} SOMA rows in the SWC; K1 {launches['soma']['frangi3d_fused']}, "
              f"K2 {launches['soma']['exact_sums']}, K3 {launches['soma']['conv1d_axis']} launches "
              f"in run 1", flush=True)
        check(n_soma > 0, "the soma path's SWC has SOMA nodes")
        # the 2-D path: the CLI on the 2-D main plane, exact and tube mode
        plane_src = os.path.join(workdir, "plane.npy")
        np.save(plane_src, plane_np)
        for mode in ("exact", "tube"):
            label = f"2d {mode}"
            launches[label], run2_s, _ = phase_main(torch, card, plane_src, workdir, mode, label,
                                                    PLANE_SHAPE, PLANE_PARAMS)

            def run(mode=mode):
                rc = cli.main(cli_argv(plane_src, workdir, f"plane_{mode}3", mode, PLANE_PARAMS))
                check(rc == 0, f"profiled 2-D {mode} CLI run exited {rc}")

            profiles[label] = phase_profile(torch, card, label, run, run2_s)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del soma_np, plane_np
    launches["unfused"], run2_s = phase_main_unfused(torch, card, main_np)
    cfg = dataclasses.replace(PNRConfig.from_cli_params(MAIN_PARAMS), fused_frangi=False)
    profiles["unfused"] = phase_profile(
        torch, card, "unfused",
        lambda: reconstruction_func(main_np, cfg, verbose=False, device=DEVICE), run2_s)
    tiled_2d = phase_tiled_2d(torch, card)
    for mode in ("exact", "tube"):
        phase_small_agreement(torch, mode)
    quality = phase_quality(torch, card)
    serving, vols, k1_exact = phase_serving(torch, card, main_np)
    sharded, virtual = phase_sharded(torch, card, main_np, main_rows)
    mesh = phase_mesh(torch, card, vols, k1_exact, virtual["exact"],
                      [sharded["exact"]["s"]], main_np)
    rest = phase_rest(torch, card, main_np, virtual["exact"].j8)
    del vols, k1_exact, virtual
    k2_ms, k2_seen = profiles["exact"]["kernels"]["K2"]
    k2.update({"device_ms_per_exact_run": k2_ms, "profiled_launches": k2_seen,
               "seed_scoring_launches": launches["exact"]["seed_scoring"]["exact_sums"],
               "exact_busy_ms": profiles["exact"]["busy_ms"]})
    print(f"[K2] device time per exact run (profiled run 3): {k2_ms:.3f} ms in {k2_seen} "
          f"launches; the card busy {profiles['exact']['busy_ms']:.3f} ms [{card}]", flush=True)
    # K1 and K3 per profiled run of each path (ms, launches the profiler saw)
    k1["device_ms_per_run"] = {m: profiles[m]["kernels"]["K1 (frangi_fused, decode_stats)"]
                               for m in ("exact", "tube")}
    k3["device_ms_per_run"] = {m: profiles[m]["kernels"]["K3 (and the map build's)"]
                               for m in ("unfused", "tube")}
    k4["device_ms_per_run"] = {"unfused": profiles["unfused"]["kernels"]["K4"]}
    print(f"[K1] device time per profiled run (ms, launches): {json.dumps(k1['device_ms_per_run'])}; "
          f"[K3] {json.dumps(k3['device_ms_per_run'])} (tube: the map build); "
          f"[K4] {json.dumps(k4['device_ms_per_run'])} [{card}]", flush=True)
    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "pnr_tpu") or m.startswith(("jax.", "pnr_tpu.")))
    check(not loaded, f"no module of jax or of pnr_tpu was imported (found {loaded})")
    print(f"[maps] the tube map build (not a TPU kernel: JAX runs an XLA shift-and-add): "
          f"{json.dumps(maps)}; launches in the tube path's run 1 "
          f"{launches['tube']['conv1d_along_axis']}", flush=True)
    print(f"[unfused] {json.dumps(unfused)}", flush=True)
    print(f"[2d] maps {json.dumps(maps_2d)}; tiled {json.dumps(tiled_2d)}; soma "
          f"{json.dumps(soma)}; quality {json.dumps(quality)}", flush=True)
    print(f"[serving] {json.dumps(serving)}", flush=True)
    print(f"[sharded] {json.dumps(sharded, default=str)}", flush=True)
    print(f"[mesh] {json.dumps(mesh, default=str)}", flush=True)
    for mode in ("exact", "tube"):
        n = serving[f"batch {mode}"]["launches"]
        k1[f"launches_batch_{mode}"] = n["K1"]
        k3[f"launches_batch_{mode}"] = n["K3"]
    k2["launches_batch_exact"] = serving["batch exact"]["launches"]["K2"]
    k5["launches_batch_tube"] = serving["batch tube"]["launches"]["tube_corr"]
    k2["launches_2d"] = launches["2d exact"]["exact_sums"]
    k2["launches_soma"] = launches["soma"]["exact_sums"]
    k2["plane"] = k2_2d
    k2["device_ms_per_2d_run"] = profiles["2d exact"]["kernels"]["K2"]
    k5.update({"launches_2d": launches["2d tube"]["tube_corr_trace"], "plane": k5_2d})
    k6.update({"launches_2d": launches["2d tube"]["tube_corr_score"], "plane": k6_2d})
    k3.update({"launches_2d": {m: launches[f"2d {m}"]["conv1d_axis"] for m in ("exact", "tube")},
               "launches_2d_map_build": launches["2d tube"]["conv1d_along_axis"],
               "launches_soma": launches["soma"]["conv1d_axis"], "plane": maps_2d["k3"]})
    k3["device_ms_per_run"].update({m: profiles[m]["kernels"]["K3 (and the map build's)"]
                                   for m in ("2d exact", "2d tube")})
    k1["launches_soma"] = launches["soma"]["frangi3d_fused"]
    for m in ("2d exact", "2d tube"):
        print(f"[2d] device time per profiled {m} run (ms, launches): "
              f"{json.dumps(profiles[m]['kernels'])} [{card}]", flush=True)
    print(f"[done] {time.perf_counter() - t_start:.3f} s in all [{card}]", flush=True)
    kernels = [
        {"name": "frangi3d_fused", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/frangi_fused.cu",
         "replaces": "pnr_tpu/ops/frangi_fused.py:265",
         "launches": launches["exact"]["frangi3d_fused"], **k1},
        {"name": "exact_sums", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/zncc_exact.cu",
         "replaces": "pnr_tpu/ops/zncc_exact.py:194",
         "launches": launches["exact"]["exact_sums"], **k2},
        {"name": "tube_corr (tracer)", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/tube_corr.cu",
         "replaces": "pnr_tpu/ops/pallas_sample.py:66",
         "launches": launches["tube"]["tube_corr_trace"], **k5},
        {"name": "tube_corr (seed scoring)", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/tube_corr.cu",
         "replaces": "pnr_tpu/ops/pallas_sample.py:145",
         "launches": launches["tube"]["tube_corr_score"], **k6},
        {"name": "conv1d_axis", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/conv.cu",
         "replaces": "pnr_tpu/ops/pallas_conv.py:41",
         "launches": launches["unfused"]["conv1d_axis"], **k3},
        {"name": "conv_yx", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/conv.cu",
         "replaces": "pnr_tpu/ops/pallas_conv.py:227",
         "launches": launches["unfused"]["conv_yx"], **k4},
        # not a TPU kernel: it replaces jax.random's Threefry inside JAX's
        # jitted stage; times at the exact stage's shape, the others under
        # "shapes"
        {"name": "threefry", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/threefry.cu",
         "replaces": "pnr_tpu/smc/tracker.py:327",
         "launches": launches["exact"]["threefry"], "launches_tube": launches["tube"]["threefry"],
         "launches_soma": launches["soma"]["threefry"],
         "launches_2d": {m: launches[f"2d {m}"]["threefry"] for m in ("exact", "tube")},
         "launches_unfused": launches["unfused"]["threefry"],
         "launches_batch_exact": serving["batch exact"]["launches"]["threefry"],
         "launches_batch_tube": serving["batch tube"]["launches"]["threefry"],
         **{k: draws["exact stage"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")},
         "max_abs_err": max(r["max_abs_err"] for r in draws.values()), "shapes": draws},
        # K7 is on no main path (the pipeline routes by device and never
        # probes): its launches are those of the build phase
        {"name": "self_check", "route": "cuda",
         "source": "pnr_tpu_torch/csrc/probe.cu",
         "replaces": "pnr_tpu/ops/pallas_conv.py:155",
         "launches": probe_launches, **k7},
    ]
    # each kernel's launches in run 1 (the graph route) of the sharded paths
    sharded_counter = {"frangi3d_fused": "frangi3d_fused", "exact_sums": "exact_sums",
                       "tube_corr (tracer)": "tube_corr_trace",
                       "tube_corr (seed scoring)": "tube_corr_score",
                       "conv1d_axis": "conv1d_axis", "conv_yx": "conv_yx",
                       "self_check": "self_check", "threefry": "threefry"}
    for row in kernels:
        for mode in ("exact", "tube"):
            row[f"launches_sharded_{mode}"] = sharded[mode]["launches"][sharded_counter[row["name"]]]
            # the stage graphs replayed there (each replayed one shard's
            # stage: its K2 or tube_corr launches and one draw)
            row[f"replays_sharded_{mode}"] = sharded[mode]["launches"]["graph_replays"]
    kernels[4]["launches_sharded_tube_map_build"] = sharded["tube"]["launches"]["conv1d_along_axis"]
    # each kernel's launches on the batch-over-a-mesh and multi-process paths
    for row in kernels:
        for path, entry in mesh.items():
            key = path.replace(" ", "_")
            row["launches_" + key] = entry["launches"][sharded_counter[row["name"]]]
            row["replays_" + key] = entry["launches"]["graph_replays"]
    kernels[4]["launches_batch_dp_tube_map_build"] = mesh["batch dp tube"]["launches"][
        "conv1d_along_axis"]
    # each kernel's launches on the paths of the rest of the port
    rest_paths = {"no_native": rest["no-native"]["launches"], "alt": rest["alt"]["launches"]}
    for mode in ("exact", "tube"):
        rest_paths[f"sharded_step_{mode}"] = rest["sharded step"][mode]["launches"]
        rest_paths[f"trace_wave_{mode}"] = rest["sharded step"][mode]["trace_wave"]["launches"]
    for row in kernels:
        for path, n in rest_paths.items():
            row[f"launches_{path}"] = n[sharded_counter[row["name"]]]
    kernels[4]["launches_sharded_step_tube_map_build"] = rest_paths["sharded_step_tube"][
        "conv1d_along_axis"]
    # graph replays of the tracer's stages in run 1 of the exact and tube
    # main paths (each replay launched one stage's K2 or tube_corr calls)
    for row in kernels:
        for mode in ("exact", "tube"):
            row[f"replays_{mode}"] = launches[mode]["graph_replays"]
            # the stage graphs its warm thread captured while the front ran
            row[f"warm_captures_{mode}"] = launches[mode]["warm_captures"]
    print(f"[rest] {json.dumps(rest, default=str)}", flush=True)
    print(f"[graphs] {json.dumps(graph_phases, default=str)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-child"]:
        sys.exit(mp_child(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]))
    sys.exit(main())
