#!/usr/bin/env python3
"""Host cost of one `tube_corr` call on a card, piece by piece.

    python scripts/torch_tube_corr_host_cost.py

A tracer evaluation (T=128 traces of N=20 particles, sigmas (2, 4, 6), the
(128, 640, 640) stack's field shape) is launch-bound: its time is the
host's. This times, per call, in loops of 5,000 calls after a warm-up, in
six rounds with the order reversed every other round: the pieces of the
wrapper (its checks, the output allocation, the ctypes call with and
without the launch), the wrapper itself and the engine call around it;
and, for scale, a four-argument launch of K7's kernel through ctypes, one
`grid_sample` call at as many rows, and one `torch.mul`. Prints the card's
name and power limit and one JSON line of median microseconds per call.
Needs a CUDA device; the field is zeros (the host cost does not depend on
its values).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_tube_corr_host_cost: no CUDA device", file=sys.stderr)
        return 1
    from pnr_tpu_torch.ops import cuda, tube_corr as tc
    from pnr_tpu_torch.ops.zncc_fast import TubePatchEngine, TubeZnccModel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    t, n = 128, 20
    field = torch.zeros((3, 128, 640, 3 * 640), device=dev)
    eng = TubePatchEngine(TubeZnccModel((2.0, 4.0, 6.0), False), 2, 2.0, device=dev)
    g = torch.Generator().manual_seed(0)
    pos = (torch.rand((t, n, 3), generator=g) * torch.tensor([600.0, 600.0, 120.0])).to(dev)
    d = torch.nn.functional.normalize(torch.randn((t, n, 3), generator=g), dim=-1).to(dev)
    corners = eng.window(field, pos.mean(dim=1))
    lay = eng.layout(field)
    p = lay.params
    launch = cuda.library().pnr_tube_corr
    out = torch.empty((2, t, n), device=dev)
    stream = cuda.raw_stream(0)
    ptr = (field.data_ptr(), corners.data_ptr(), pos.data_ptr(), d.data_ptr(), out.data_ptr())
    x = torch.ones((8, 128), device=dev)
    y = torch.empty_like(x)
    fin = field.view(3, 128, 640, 640, 3).permute(0, 4, 1, 2, 3)
    grid = torch.rand((3, 1, 1, t * n * 9, 3), generator=g).to(dev) * 0.05  # local rows

    def checks():
        # _tube_corr_cuda's reads of device, dtype, shape and contiguity
        field.get_device(), corners.get_device(), pos.get_device(), d.get_device()
        field.dtype, corners.dtype, pos.dtype, d.dtype
        pos.shape == d.shape, field.shape == p.field_shape
        field.is_contiguous(), corners.is_contiguous(), pos.is_contiguous(), d.is_contiguous()

    cases = {
        "checks": checks,
        "output allocation (new_empty)": lambda: pos.new_empty((2, t, n)),
        "ctypes call, no launch (T=0)": lambda: launch(ptr[0], 0, p.address, ptr[1], ptr[2], ptr[3],
                                                       0, n, ptr[4], ptr[4] + 4 * t * n, None,
                                                       stream),
        "ctypes call with the launch": lambda: launch(ptr[0], 0, p.address, ptr[1], ptr[2], ptr[3],
                                                      t, n, ptr[4], ptr[4] + 4 * t * n, None,
                                                      stream),
        "K7 launch through ctypes (4 arguments)": lambda: cuda.library().pnr_probe(
            x.data_ptr(), y.data_ptr(), x.numel(), stream),
        "tube_corr wrapper": lambda: tc.tube_corr(field, lay.groups, corners, pos, d, eng.tables,
                                                  p),
        "engine.likelihood": lambda: eng.likelihood(field, corners, pos, d),
        "grid_sample, as many rows": lambda: F.grid_sample(fin, grid, mode="bilinear",
                                                           padding_mode="border",
                                                           align_corners=True),
        "torch.mul": lambda: torch.mul(x, 2.0),
    }
    res = {k: [] for k in cases}
    for rnd in range(6):
        for k, fn in (list(cases.items()) if rnd % 2 == 0 else reversed(list(cases.items()))):
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5000):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            res[k].append((t1 - t0) / 5000 * 1e6)
    print(json.dumps({"us_per_call_median": {k: statistics.median(v) for k, v in res.items()},
                      "us_per_call_rounds": res, "card": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
