#!/usr/bin/env python3
"""The PyTorch port's sharded pipeline on a virtual mesh of four shards of
one card, for comparing two checkouts.

    python scripts/torch_sharded_ab.py ROOT LABEL

Runs `reconstruction_func_sharded` from the checkout at ROOT over
`Mesh((cuda:0,) * 4)` on chip_smoke.py's 52.4-Mvox (128, 640, 640) stack
(make_volume's recipe, seed 0) with its parameters, four times in exact
mode and four in tube mode (the runs after the first are the warm ones),
and prints one line: LABEL and a JSON object with each mode's seconds a
run, its tracing stage, its SWC nodes and handoffs. It needs a CUDA
device. To compare a parent commit with a change on one card, unpack the
parent with `git archive` and run the two in turns (parent, change,
change, parent), each in a fresh process, in one session.
"""

import json
import os
import sys
import time

import numpy as np


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
    shape = (128, 640, 640)
    rng = np.random.default_rng(0)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] / 2) ** 2 + ((z - shape[0] / 2) * 2.0) ** 2
    vol = np.clip(200.0 * np.exp(-d2 / 18.0) * (0.7 + 0.3 * np.sin(x / 4.0))
                  + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)
    mesh = Mesh((torch.device("cuda", 0),) * 4)
    out = {}
    for mode in ("exact", "tube"):
        cfg = PNRConfig(sigmas=(2.0, 4.0, 6.0), tolerance=10.0, znccth=0.5, kappa=3.0, step=2,
                        ni=100, np=20, zdist=2.0, nodepervol=4, vol=9, zncc_mode=mode)
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
