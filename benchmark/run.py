"""Run one cell of the benchmark of pnr_tpu_torch once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json` `workloads`) names
a configuration (`benchmark/configs/<config>.json`: the 11 parameters of
the upstream plugin and the engine) and a traffic mix
(`benchmark/traffic/<traffic>.json`: the generator's parameters, the loop,
prefetch and the pool). Set-up makes the pool of stacks on the card from
`--seed`, copies each to the host as a loaded stack, and warms up on the
first stacks; the window then serves the rest of the pool for `--seconds`
seconds: one stack after another through `reconstruction_func`
(`"loop": "single"`), or one `reconstruction_batch` with prefetch over the
pool, whose first results are the warm-up (`"loop": "batch"`).

With `--trace 0` the result line carries the cell's end-to-end metrics;
with `--trace 1` the window's last TRACE_SECONDS run under torch.profiler
and the line carries the per-layer metrics, each read by
`benchmark/metrics/<name>.py`: the stage timings from the stacks before
the profiler started, the device readings from the traced span. Either
way, once the window has closed and the peak memory is read, a sample of
the window's stacks is checked against the plain reference
(benchmark/core/check.py) and all of its trees against the generator's
gold, each number printed beside its limit; the last line of standard
output is one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: build and kernel caches of the program and of torch, at fixed paths
#: inside the checkout, so that only a checkout's first run builds
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "pnr_tpu")


def _set_caches():
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_cell(name: str):
    """(manifest, workload, config, traffic) of the cell `name`, each a dict."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    cell = next((w for w in man["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return man, cell, config, traffic


def make_cfg(config: dict):
    from pnr_tpu_torch import PNRConfig

    cfg = PNRConfig.from_cli_params(config["params"])
    return dataclasses.replace(cfg, **config["options"])


def counters() -> dict:
    """The port's launch counters, by name (absent ones left out)."""
    from pnr_tpu_torch.ops import frangi_fused, threefry, tube_corr, zncc_exact
    from pnr_tpu_torch.smc import graphs

    spec = {"k1": (frangi_fused, "LAUNCHES"), "k2": (zncc_exact, "LAUNCHES"),
            "tube_corr_trace": (tube_corr, "TRACE_LAUNCHES"),
            "tube_corr_score": (tube_corr, "SCORE_LAUNCHES"), "threefry": (threefry, "LAUNCHES"),
            "graph_replays": (graphs, "REPLAYS"), "graph_captures": (graphs, "CAPTURES")}
    return {k: int(getattr(m, a)) for k, (m, a) in spec.items() if hasattr(m, a)}


def tree_rows(tree):
    """SWC rows (one per node and link, as the plugin writes them)."""
    import numpy as np

    rows = []
    for i in range(1, len(tree)):
        base = [i, tree.type[i], tree.x[i], tree.y[i], tree.z[i], tree.sig[i]]
        for p in (tree.nbr[i] or [-1]):
            rows.append(base + [p])
    return np.asarray(rows, np.float64).reshape(-1, 7)


class Record:
    """What the per-layer metric readers read: the window's stacks before
    the profiler started and their seconds (`stacks`, `window_s`: the stage
    timings); the traced span's stacks, the counters' change over it and
    its trace (`traced_stacks`, `counts`, `trace`: the device readings);
    the configuration."""

    def __init__(self, cfg, cell, traffic, stacks, window_s, traced_stacks, counts, trace, shape):
        self.cfg, self.cell, self.traffic = cfg, cell, traffic
        self.stacks, self.window_s = stacks, window_s
        self.traced_stacks, self.counts, self.trace = traced_stacks, counts, trace
        self.shape = tuple(shape)
        self.voxels = math.prod(self.shape)

    def stage_ms(self, stage: str):
        if not self.stacks:
            return None
        return 1e3 * sum(s["timings"].get(stage, 0.0) for s in self.stacks) / len(self.stacks)


#: the traced run profiles the window's last TRACE_SECONDS, from the first
#: completion at or after that point (less the profiler's start-up) to the
#: close: the profiler's processing grows with its events (tens of millions
#: in a 51-s exact window, minutes to read), and it slows the host (~2.5 ->
#: ~3 s a stack), so the stage timings come from the stacks before it starts
TRACE_SECONDS = 12.0


def host_reading():
    """(wall s, this process's CPU s): how many cores the run kept busy."""
    cpu = os.times()
    return time.perf_counter(), cpu.user + cpu.system


def host_line(a, b) -> str:
    wall = b[0] - a[0]
    return (f"host over {wall:.3f} s: this process {b[1] - a[1]:.3f} CPU s "
            f"({(b[1] - a[1]) / wall:.2f} of {os.cpu_count()} cores)")


#: the program's layers the traced run wraps in spans of the benchmark's own
#: (name, module, function): the calls the pipeline makes by module name
SPANS = (("front", "pnr_tpu_torch.pipeline.reconstruct", "_stack_front"),
         ("seed flood", "pnr_tpu_torch.pipeline.reconstruct", "seed_mask"),
         ("seed scoring", "pnr_tpu_torch.pipeline.reconstruct", "_score_seeds"),
         ("tracing", "pnr_tpu_torch.pipeline.reconstruct", "_trace_stack"),
         ("graph", "pnr_tpu_torch.pipeline.reconstruct", "reconstruct_graph"))


def wrap_spans():
    """Wrap each of SPANS in a record_function named after its layer;
    returns the undo."""
    from torch.autograd.profiler import record_function

    from benchmark.core.profile import SPAN_PREFIX

    real = []
    for name, mod_name, fn in SPANS:
        mod = importlib.import_module(mod_name)
        f = getattr(mod, fn)

        def spanned(*a, _f=f, _n=SPAN_PREFIX + name, **k):
            with record_function(_n):
                return _f(*a, **k)

        real.append((mod, fn, f))
        setattr(mod, fn, spanned)

    def undo():
        for mod, fn, f in real:
            setattr(mod, fn, f)

    return undo


def warm_profiler(device) -> float:
    """Two short profiler sessions in set-up: the first in a process loads
    and starts the device tracer; the second's start, returned in seconds,
    is what starting one inside the window costs, so the trace starts that
    much earlier and its span still holds TRACE_SECONDS of work."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    took = 0.0
    for _ in range(2):
        t = time.perf_counter()
        prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        took = time.perf_counter() - t
        x = torch.ones(64, device=device)
        for _ in range(8):
            x = x * 1.0
        torch.cuda.synchronize()
        prof.stop()
    return took


def read_metric(name: str, rec: Record):
    mod = importlib.import_module(f"benchmark.metrics.{name}")
    v = mod.read(rec)
    return None if v is None else float(v)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             traffic_override: dict = None, config_override: dict = None,
             check_stacks: int = None, log=print):
    """Set-up, the window, the metrics and the check of one run. Returns
    the result line (a dict). `traffic_override` replaces keys of the
    traffic file and `config_override` fields of the configuration (the
    CPU tests' small stacks and short traces)."""
    import torch

    man, cell, config, traffic = load_cell(workload)
    if traffic_override:
        traffic = {**traffic, **traffic_override}
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    from pnr_tpu_torch.pipeline.reconstruct import reconstruction_batch, reconstruction_func

    from benchmark.core import check, profile, swc_compare, window

    t_imports = time.perf_counter()
    cfg = make_cfg(config)
    if config_override:
        cfg = dataclasses.replace(cfg, **config_override)
    gen = importlib.import_module(f"benchmark.traffic.{traffic['generator']}")
    n_pool = int(traffic["pool_stacks"])
    pool, golds = gen.make_pool(traffic["stack"], seed, n_pool, cfg.zdist, device)
    if on_card:
        torch.cuda.synchronize()
    t_pool = time.perf_counter()
    start_s = warm_profiler(device) if trace and on_card else 0.0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    undo_spans = []
    n_warm = int(traffic["warmup_stacks"])
    win = window.Window(seconds)
    done = []  # (pool index, result) of the window's stacks
    prof = span = None
    c0 = None
    traced = {}  # the traced span: where it starts, its length, the counters' change
    host0 = None

    def start_trace(t):
        nonlocal prof, span, c0
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile as tprofile

        prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        undo_spans.append(wrap_spans())
        prof.start()
        # the profiler drops a session's first device events
        x = torch.ones(64, device=device)
        for _ in range(32):
            x = x * 1.0
        sync()
        span = record_function(profile.WINDOW)
        span.__enter__()
        c0 = counters()
        now = time.perf_counter()
        traced.update(n0=len(done), t0=now, start_s=now - t)

    def open_window():
        nonlocal host0
        host0 = host_reading()
        win.open(time.perf_counter())
        if trace and on_card and seconds <= TRACE_SECONDS + start_s:
            start_trace(win.t_open)

    def completed(i, res) -> bool:
        """Record a window stack; start the trace TRACE_SECONDS before the
        window's end, end it at the close; True when the window closes."""
        t = time.perf_counter()
        done.append((i, res))
        closes = win.complete(t)
        if trace and on_card and prof is None and not closes \
                and t - win.t_open >= seconds - TRACE_SECONDS - start_s:
            start_trace(t)
        elif closes and span is not None:
            span.__exit__(None, None, None)
            prof.stop()
            c = counters()
            traced.update(s=t - traced["t0"], counts={k: c[k] - c0[k] for k in c})
            for undo in undo_spans:
                undo()
        return closes

    if traffic["loop"] == "single":
        for i in range(n_warm):
            reconstruction_func(pool[i], cfg, verbose=False, device=device)
        sync()
        t_warm = time.perf_counter()
        open_window()
        i = n_warm
        while True:
            if i >= len(pool):
                raise window.PoolExhausted(len(pool))
            res = reconstruction_func(pool[i], cfg, verbose=False, device=device)
            sync()
            i += 1
            if completed(i - 1, res):
                break
    else:
        stream = reconstruction_batch(iter(pool), cfg, verbose=False,
                                      prefetch=bool(traffic["prefetch"]),
                                      prefetch_depth=int(traffic["prefetch_depth"]), device=device)
        try:
            for i, res in enumerate(stream):
                sync()
                if i < n_warm - 1:
                    continue
                if i == n_warm - 1:
                    t_warm = time.perf_counter()
                    open_window()
                    continue
                if completed(i, res):
                    break
            else:
                raise window.PoolExhausted(len(pool))
        finally:
            stream.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(host_line(host0, host_reading()), file=sys.stderr)
    setup_s = win.t_open - T_START
    log(f"setup {setup_s:.3f} s: imports {t_imports - T_START:.3f} s, pool {t_pool - t_imports:.3f} s "
        f"({n_pool} stacks), warm-up {t_warm - t_pool:.3f} s ({n_warm} stacks); window "
        f"{win.length:.3f} s, {len(done)} stacks", file=sys.stderr)

    stacks = []
    for k, (i, res) in enumerate(done):
        t_prev = win.t_open if k == 0 else win.done[k - 1]
        stacks.append({"index": i, "timings": dict(res.timings), "n_raw_seeds": int(res.n_raw_seeds),
                       "n_seeds": int(len(res.seeds_pos)), "traces": int(res.trace_count),
                       "n0": len(res.n0) - 1, "tree": len(res.tree) - 1,
                       "s": win.done[k] - t_prev})
    log("stack seconds: " + " ".join(f"{s['s']:.3f}" for s in stacks), file=sys.stderr)
    log("stacks (index, raw seeds, seeds, traces, n0, tree): " + " ".join(
        f"({s['index']},{s['n_raw_seeds']},{s['n_seeds']},{s['traces']},{s['n0']},{s['tree']})"
        for s in stacks), file=sys.stderr)
    stages = sorted({k for s in stacks for k in s["timings"]})
    log("stage ms a stack: " + ", ".join(
        f"{k} {1e3 * sum(s['timings'].get(k, 0.0) for s in stacks) / max(len(stacks), 1):.1f}"
        for k in stages), file=sys.stderr)

    tr = profile.read(prof) if prof is not None else None
    prof = None
    out = {"correct": False, "attempted": len(done),
           "failed": sum(1 for s in stacks if s["tree"] == 0), "metrics": {}}
    t_f1 = time.perf_counter()
    m_tot = t_tot = g_tot = 0
    for i, res in done:
        sc = swc_compare.compare_swc(tree_rows(res.tree), golds[i], dist=4.0, resample=1.0)
        m_tot, t_tot, g_tot = m_tot + sc.n_matched, t_tot + sc.n_test, g_tot + sc.n_gold
    f1 = 1.0 - check.f1_short(m_tot, t_tot, g_tot)
    log(f"swc_f1 {f1:.6f} over {len(done)} stacks: {m_tot} matched of {t_tot} traced and "
        f"{g_tot} gold nodes ({time.perf_counter() - t_f1:.3f} s)", file=sys.stderr)
    if trace:
        # the stage timings from the stacks before the trace (all of them
        # where the trace took the whole window), the device readings from
        # the traced span
        n_before = traced.get("n0", len(stacks)) or len(stacks)
        before_s = win.done[n_before - 1] - win.t_open if stacks else 0.0
        after = stacks[traced["n0"]:] if "n0" in traced else []
        if after:
            log(f"traced span {traced['s']:.3f} s (the profiler started in "
                f"{traced['start_s']:.3f} s, {start_s:.3f} s in set-up), {len(after)} stacks; "
                f"stage timings from "
                f"{n_before} stacks in {before_s:.3f} s", file=sys.stderr)
        rec = Record(cfg, cell, traffic, stacks[:n_before], before_s, after,
                     traced.get("counts", {}), tr, traffic["stack"]["shape"])
        for m in man["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = read_metric(m["name"], rec)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in man["end_to_end"]}
        vals = {"stacks_per_s": win.rate, "swc_f1": f1, "setup_s": setup_s}
        for m in man["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                out["metrics"][m["name"]] = {"value": vals[m["name"]], "unit": units[m["name"]]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    out["device"] = dev

    # the check: the program's state is freed, then the reference runs on
    # the sample, stack by stack
    t_check = time.perf_counter()
    limits = config["correct_limits"]
    pick = check.sample([s["n0"] for s in stacks], check_stacks or int(traffic["check_stacks"]), seed)
    keep = [(done[k][0], check.outputs_of(done[k][1])) for k in pick]
    done = stream = res = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = check.Reference(cfg, device)
    per = []
    for i, o in keep:
        per.append(ref.compare(pool[i], o))
        log(f"check stack {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in per[-1].items()),
            file=sys.stderr)
    worst = check.worst(per)
    worst["f1_short"] = 1.0 - f1
    # a number whose limit is null is printed and not compared
    ok = bool(per) and all(worst[k] <= limits[k] for k in check.ALL if limits[k] is not None)
    out["correct"] = ok and len(stacks) > 0
    log(f"check: {len(per)} stacks in {time.perf_counter() - t_check:.3f} s, correct "
        f"{out['correct']}; the run took {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    for k in check.ALL:
        lim = "none (not compared)" if limits[k] is None else f"{limits[k]:.6g}"
        log(f"{k} {worst.get(k, float('nan')):.6g} limit {lim}", file=sys.stderr)
    out["checks"] = {k: {"value": worst.get(k), "limit": limits[k]} for k in check.ALL}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_caches()
    _, cell, _, _ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if found:
        print(f"the process loaded {', '.join(found)}: no result", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
