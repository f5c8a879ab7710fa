"""The readings the limits of `correct` are set from, for one cell.

    python benchmark/control.py --workload <name> --seeds <s1,s2,...> [--stacks 1]
        [--controls 3]

For each seed, the cell's first `--stacks` stacks of that seed go through
the program as the cell serves them (`reconstruction_func` one at a time,
or `reconstruction_batch` with the cell's prefetch), and each is compared
with the plain reference (benchmark/core/check.py) and its tree with the
generator's gold (`f1_short`, one stack's): the sound readings. Then, on
the first `--controls` seeds, the control takes the program's place and is
compared the same way:

* the reference computed in bfloat16 (its J8, its seeds, its likelihood at
  the program's nodes, and its graph stage from the program's traced
  nodes), the precision below the float32 the configuration states;
* in tube mode also the program's own bfloat16 map field
  (`tube_map_dtype="bf16"`), the program's lower-precision path.

A stage that returns its state unchanged reads 1 on `node_step_off` by
construction and needs no run. Prints one line per seed and stack, then a
JSON line: per number the largest sound reading and each control's
smallest.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402


def program_outputs(vols, cfg, traffic, device):
    from pnr_tpu_torch.pipeline.reconstruct import reconstruction_batch, reconstruction_func

    from benchmark.core import check

    if traffic["loop"] == "single":
        results = [reconstruction_func(v, cfg, verbose=False, device=device) for v in vols]
    else:
        results = list(reconstruction_batch(vols, cfg, verbose=False,
                                            prefetch=bool(traffic["prefetch"]),
                                            prefetch_depth=int(traffic["prefetch_depth"]),
                                            device=device))
    return [check.outputs_of(r) for r in results]


def f1_short(out, gold) -> float:
    """1 - F1 of the output's tree against the gold, as run.py scores it."""
    import numpy as np

    from benchmark.core import check, swc_compare

    par = out.tree_par
    rows = np.column_stack([np.arange(1, len(par) + 1), np.full(len(par), 2), out.tree_xyz,
                            np.ones(len(par)), np.where(par >= 0, par + 1, -1)])
    sc = swc_compare.compare_swc(rows, gold, dist=4.0, resample=1.0)
    return check.f1_short(sc.n_matched, sc.n_test, sc.n_gold)


def readings(workload, seeds, n_stacks, device="cuda", traffic_override=None,
             config_override=None, n_controls=3, log=print):
    """{number: (largest sound reading, smallest control reading)} over the
    seeds, and the per-seed rows."""
    import torch

    from benchmark.core import check

    _, cell, config, traffic = run.load_cell(workload)
    if traffic_override:
        traffic = {**traffic, **traffic_override}
    cfg = run.make_cfg(config)
    if config_override:
        cfg = dataclasses.replace(cfg, **config_override)
    gen = __import__(f"benchmark.traffic.{traffic['generator']}", fromlist=["make_pool"])
    ref32 = check.Reference(cfg, device, torch.float32)
    ref16 = check.Reference(cfg, device, torch.bfloat16)
    progs = {"program": cfg}
    if cfg.zncc_mode == "tube":
        progs["program bf16 maps"] = dataclasses.replace(cfg, tube_map_dtype="bf16")
    rows = []
    for n_seed, seed in enumerate(seeds):
        control = n_seed < n_controls
        vols, golds = gen.make_pool(traffic["stack"], seed, n_stacks, cfg.zdist, device)
        outs = {name: program_outputs(vols, c, traffic, device) for name, c in progs.items()
                if control or name == "program"}
        for k, vol in enumerate(vols):
            t0 = time.perf_counter()
            prog = outs["program"][k]
            row = {"seed": seed, "stack": k,
                   "sound": {**ref32.compare(vol, prog), "f1_short": f1_short(prog, golds[k])}}
            if control:
                ctrl = ref16.outputs(vol, prog)
                row["control bf16 reference"] = {**ref32.compare(vol, ctrl),
                                                 "f1_short": f1_short(ctrl, golds[k])}
            if "program bf16 maps" in outs:
                alt = outs["program bf16 maps"][k]
                row["control bf16 maps"] = {**ref32.compare(vol, alt),
                                            "f1_short": f1_short(alt, golds[k])}
            rows.append(row)
            log(json.dumps({**row, "s": time.perf_counter() - t0}), flush=True)
            if device == "cuda":
                torch.cuda.empty_cache()
    kinds = [k for k in rows[0] if k.startswith("control")]
    summary = {num: {"sound max": max(r["sound"][num] for r in rows),
                     **{f"{k} min": min(r[k][num] for r in rows if k in r) for k in kinds}}
               for num in check.ALL}
    return summary, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--stacks", type=int, default=1)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    run._set_caches()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    summary, _ = readings(args.workload, seeds, args.stacks, n_controls=args.controls)
    print(json.dumps({"workload": args.workload, "seeds": seeds,
                      "card": torch.cuda.get_device_name(0), "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
