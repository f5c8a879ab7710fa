#!/usr/bin/env python3
"""The PyTorch port's sharded pipeline on a virtual mesh of four shards of
one card, for comparing two checkouts.

    python scripts/torch_sharded_ab.py ROOT LABEL

Runs `reconstruction_func_sharded` from the checkout at ROOT over
`Mesh((cuda:0,) * 4)` on chip_smoke.py's 52.4-Mvox (128, 640, 640) stack
(`make_volume`, seed 0) with its CLI parameters, four times in exact
mode and four in tube mode (the runs after the first are the warm ones),
and prints one line: LABEL and a JSON object with each mode's seconds a
run, its tracing stage, its SWC nodes and handoffs. It needs a CUDA
device. To compare a parent commit with a change on one card, unpack the
parent with `git archive` and run the two in turns (parent, change,
change, parent), each in a fresh process, in one session.
"""

import dataclasses
import json
import os
import sys
import time

from torch_ab_common import load_smoke


def main(root: str, label: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from pnr_tpu_torch import PNRConfig
    from pnr_tpu_torch.ops import cuda
    from pnr_tpu_torch.parallel import Mesh
    from pnr_tpu_torch.pipeline import reconstruction_func_sharded

    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(cuda.__file__))))
    if here != root:
        raise SystemExit(f"loaded pnr_tpu_torch from {here}, not from {root}")
    cuda.self_check()
    smoke = load_smoke()
    vol = smoke.make_volume(smoke.MAIN_SHAPE)
    mesh = Mesh((torch.device("cuda", 0),) * 4)
    out = {}
    for mode in ("exact", "tube"):
        cfg = dataclasses.replace(PNRConfig.from_cli_params(smoke.MAIN_PARAMS), zncc_mode=mode)
        secs, tracing = [], []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = reconstruction_func_sharded(vol, cfg, mesh, verbose=False)
            torch.cuda.synchronize()
            secs.append(round(time.perf_counter() - t0, 4))
            tracing.append(round(res.timings["tracing (sharded, staged handoff)"], 4))
        out[mode] = {"s": secs, "tracing": tracing, "nodes": len(res.tree) - 1,
                     "handoffs": res.n_handoffs}
    print(label, json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
