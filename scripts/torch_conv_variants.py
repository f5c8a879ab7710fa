#!/usr/bin/env python3
"""K4 built from several versions of conv.cu, timed in turns on one card.

    python scripts/torch_conv_variants.py NAME=CSRC_DIR [NAME=CSRC_DIR ...] [--out DIR] [--sass]

Compiles each CSRC_DIR/conv.cu (with its headers) with the port's nvcc
flags into its own shared library under DIR (the gitignored
pnr_tpu_torch/_build/conv_variants by default), all builds at once, and
calls each library's `pnr_conv_yx` on chip_smoke.py's (128, 640, 640) stack, uint8 and float32, at sigmas
2, 4 and 6 (13, 25 and 37 taps along y and x): per call in runs of 20
back-to-back launches (CUDA events), the variants and K3 along y then K3
along x (this checkout's `conv.conv1d_axis`) in turns. Prints, per sigma
and type, one JSON line with each variant's time in ms, whether its
output is bitwise the first variant's, and the first's max|d| /
max|plain| against `conv_yx_plain`. With --sass, also prints each
variant's `conv_yx_kernel` instruction counts (cuobjdump) and writes its
SASS under DIR. Every version must export `pnr_conv_yx` with this
checkout's signature. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sass_counts(nvcc, cu, out_dir, name):
    cubin = os.path.join(out_dir, f"{name}.cubin")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-o", cubin, cu], check=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s+Function : ", sass):
        head = fn.split("\n")[0].strip()
        if "conv_yx_kernel" not in head:
            continue
        kind = "u8" if "IhE" in head else "f32"
        with open(os.path.join(out_dir, f"{name}_{kind}.sass"), "w") as f:
            f.write(fn)
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", fn))
        print(json.dumps({"variant": name, "kernel": kind, "instructions": sum(ops.values()),
                          "top": dict(ops.most_common(12))}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--out", default=os.path.join(HERE, "pnr_tpu_torch", "_build", "conv_variants"))
    ap.add_argument("--sass", action="store_true", help="print and keep each variant's SASS")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_conv_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, HERE)
    from pnr_tpu_torch.ops import conv, cuda
    from pnr_tpu_torch.ops.gaussian import gaussian_kernel

    os.makedirs(args.out, exist_ok=True)
    nvcc = cuda._nvcc()
    builds = {}
    for v in args.variants:
        name, csrc = v.split("=", 1)
        so = os.path.join(args.out, f"{name}.so")
        cu = os.path.join(csrc, "conv.cu")
        builds[name] = (subprocess.Popen([nvcc, *cuda.NVCC_FLAGS, "-o", so, cu],
                                         stderr=subprocess.PIPE, text=True), so, cu)
    libs = {}
    for name, (proc, so, cu) in builds.items():
        err = proc.communicate()[1]
        if proc.returncode:
            print(f"torch_conv_variants: {name} failed to build:\n{err}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(so)
        lib.pnr_conv_yx.argtypes = list(cuda._SIGNATURES["pnr_conv_yx"])
        libs[name] = lib
        if args.sass:
            sass_counts(nvcc, cu, args.out, name)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    vol = torch.from_numpy(cs.make_volume(cs.MAIN_SHAPE)).cuda()
    z, y, x = vol.shape
    names = list(libs)
    for sig in cs.SIGMAS:
        k = np.ascontiguousarray(gaussian_kernel(sig), np.float32)
        for dt, v in (("u8", vol), ("f32", vol.to(torch.float32))):
            outs = {n: torch.empty((z, y, x), device="cuda") for n in names}

            def launch(n, v=v, k=k):
                err = libs[n].pnr_conv_yx(v.data_ptr(), int(v.dtype == torch.uint8),
                                          outs[n].data_ptr(), z, y, x, k.ctypes.data, k.size,
                                          k.ctypes.data, k.size, cuda.raw_stream(0))
                if err:
                    raise RuntimeError(f"{n}: pnr_conv_yx returned cudaError {err}")

            fns = [lambda n=n: launch(n) for n in names]
            fns.append(lambda v=v, k=k: conv.conv1d_axis(conv.conv1d_axis(v, k, 1), k, 2))
            times = cs.time_turns_ms(torch, fns, reps=9, calls=20, warmup=3)
            first = outs[names[0]]
            plain = conv.conv_yx_plain(v, k, k)
            row = {"card": card, "sigma": sig, "dtype": dt,
                   "ms": dict(zip(names, times[:-1])), "k3_pair_ms": times[-1],
                   "bitwise_first": {n: bool(torch.equal(outs[n], first)) for n in names},
                   "first_err": float((first - plain).abs().max() / plain.abs().max())}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
