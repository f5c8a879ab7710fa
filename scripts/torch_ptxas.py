#!/usr/bin/env python3
"""ptxas's resource line for each CUDA kernel of a checkout of the port.

    python scripts/torch_ptxas.py [--root DIR] [SOURCE ...]

Compiles `pnr_tpu_torch/csrc/*.cu` of the checkout at DIR (this one by
default), or only the named sources (file names such as conv.cu), with
the port's nvcc flags (ops/cuda.NVCC_FLAGS) and `-Xptxas -v` into a
throw-away object under the system's temporary directory, and prints one
line per kernel: its demangled name, registers, stack frame, spill
stores and loads, and constant-bank and shared-memory bytes. A stack
frame or spills show that the kernel keeps something in local memory
(for example a by-value parameter indexed at run time). Needs nvcc.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def demangle(names):
    proc = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
    out = proc.stdout.splitlines() if proc.returncode == 0 else []
    return out if len(out) == len(names) else list(names)


def report(root: str, sources) -> int:
    sys.path.insert(0, HERE)
    from pnr_tpu_torch.ops import cuda

    csrc = os.path.join(root, "pnr_tpu_torch", "csrc")
    files = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    if sources:
        files = [f for f in files if os.path.basename(f) in sources]
    flags = [f for f in cuda.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for f in files:
            cmd = [cuda._nvcc(), *flags, "-c", "-Xptxas", "-v", "-o",
                   os.path.join(tmp, os.path.basename(f) + ".o"), f]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stderr, file=sys.stderr)
                return proc.returncode
            name = None
            for line in proc.stderr.splitlines():
                m = re.search(r"Compiling entry function '([^']+)'", line)
                if m:
                    name = m.group(1)
                    frame = {}
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
                if m and name:
                    frame = dict(zip(("stack", "spill_st", "spill_ld"), map(int, m.groups())))
                m = re.search(r"Used (\d+) registers(.*)", line)
                if m and name:
                    rows.append((os.path.basename(f), name, int(m.group(1)), frame,
                                 m.group(2).strip(", ")))
                    name = None
    for (src, _, regs, frame, rest), pretty in zip(rows, demangle([r[1] for r in rows])):
        print(f"{src}: {pretty}: {regs} registers, {frame.get('stack', 0)} bytes stack frame, "
              f"{frame.get('spill_st', 0)} bytes spill stores, {frame.get('spill_ld', 0)} bytes "
              f"spill loads; {rest}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose csrc/*.cu compiles")
    ap.add_argument("sources", nargs="*", help="source file names (default: all)")
    args = ap.parse_args()
    return report(os.path.abspath(args.root), set(args.sources))


if __name__ == "__main__":
    sys.exit(main())
