#!/usr/bin/env python3
"""K1, K3 and K4 of a checkout of the port, timed on one card.

    python scripts/torch_filter_kernels.py [--root DIR] [--reps N]

Runs `pnr_tpu_torch` from the checkout at DIR (this one by default) on
chip_smoke.py's 52.4-Mvox (128, 640, 640) stack: K1 (`frangi3d_fused`) at
sigmas (2, 4, 6) and at each sigma alone, and K3 (`conv.conv1d_axis`) on
the float32 stack along each axis at 3 taps (the Hessian's differences,
grad_border), 19 taps (the z Gaussian at sigma 6) and 37 taps (sigma 6),
and K4 (`conv.conv_yx`) on the uint8 stack at sigmas 2, 4 and 6 (13, 25
and 37 taps along y and x) beside K3 along y then K3 along x with the
same taps, each the median of N timed calls (CUDA events, after a
warm-up). Prints one JSON line with the card's name and power limit and
the SHA-256 of K4's sigma-6 output and of K1's outputs (J, Jmin, Jmax
and the three directions at sigmas 2, 4, 6): two checkouts whose kernel
computes the same bits print the same digest. To compare two checkouts on one card,
run them in turns (parent, change, change, parent) in one session. Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose pnr_tpu_torch runs")
    ap.add_argument("--reps", type=int, default=11, help="timed calls per case")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("torch_filter_kernels: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    from pnr_tpu_torch.ops import conv
    from pnr_tpu_torch.ops.frangi_fused import frangi3d_fused
    from pnr_tpu_torch.ops.gaussian import gaussian_kernel

    if not conv.__file__.startswith(root):
        raise RuntimeError(f"pnr_tpu_torch came from {conv.__file__}, not from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    vol = torch.from_numpy(cs.make_volume(cs.MAIN_SHAPE)).cuda()
    vol_f = vol.to(torch.float32)
    row = {"root": root, "card": card, "shape": list(cs.MAIN_SHAPE)}
    row["k1_ms"] = cs.time_ms(torch, lambda: frangi3d_fused(vol, cs.SIGMAS, cs.ZDIST), args.reps)
    for s in cs.SIGMAS:
        row[f"k1_sigma{s:g}_ms"] = cs.time_ms(torch, lambda s=s: frangi3d_fused(vol, (s,), cs.ZDIST),
                                              args.reps)
    for name, k, grad in (("3", (-0.5, 0.0, 0.5), True),
                          ("19", gaussian_kernel(cs.SIGMAS[-1] / cs.ZDIST), False),
                          ("37", gaussian_kernel(cs.SIGMAS[-1]), False)):
        row[f"k3_{name}taps_zyx_ms"] = [
            cs.time_ms(torch, lambda a=a: conv.conv1d_axis(vol_f, k, a, grad), args.reps)
            for a in (0, 1, 2)]
    for s in cs.SIGMAS:
        k = gaussian_kernel(s)
        row[f"k4_sigma{s:g}_ms"] = cs.time_ms(torch, lambda k=k: conv.conv_yx(vol, k, k), args.reps)
        row[f"k3_pair_sigma{s:g}_ms"] = cs.time_ms(
            torch, lambda k=k: conv.conv1d_axis(conv.conv1d_axis(vol, k, 1), k, 2), args.reps)
    k = gaussian_kernel(cs.SIGMAS[-1])
    row["k4_sigma6_u8_sha256"] = cs.k4_digest(conv.conv_yx(vol, k, k))
    h = hashlib.sha256()
    for t in frangi3d_fused(vol, cs.SIGMAS, cs.ZDIST):
        h.update(t.contiguous().cpu().numpy().tobytes())
    row["k1_sha256"] = h.hexdigest()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
