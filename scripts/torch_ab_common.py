"""What the PyTorch port's A/B scripts share (scripts/torch_*_ab.py): this
checkout's chip_smoke.py as a module (its stacks, parameters and checks,
so that two checkouts run the same work), the card's name and power
limit, the order of turns that pairs two trees on one card, the parallel
build of each tree's kernel and native libraries, one tree's run in a
fresh process, and a median with its range.

Imported by the scripts beside it (`python scripts/torch_<x>_ab.py`
puts this directory first on sys.path).
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

#: the checkout these scripts belong to
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """This checkout's chip_smoke.py, loaded as the module `chip_smoke`."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def turn_order(n: int, turns: int):
    """Indices of n trees (or routes) in turns, every other turn reversed:
    for two and two turns A, B, B, A."""
    order = []
    for turn in range(turns):
        order += list(range(n)) if turn % 2 == 0 else list(range(n))[::-1]
    return order


def build_trees(trees) -> bool:
    """Build or load each tree's kernel library and native host library,
    one process a tree, all started together; True when all built."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from pnr_tpu_torch.ops import cuda; from pnr_tpu_torch import native; "
            "cuda.build(); assert native.have_native()")
    procs = [subprocess.Popen([sys.executable, "-c", code, os.path.abspath(t)]) for t in trees]
    return all(p.wait() == 0 for p in procs)


def run_child(script: str, tree: str, args, prefix: str):
    """Run `script --child TREE ARGS` in a fresh process from the tree's
    root: the JSON object its output prints after `prefix`, or None when
    it fails (the end of its errors printed)."""
    proc = subprocess.run([sys.executable, os.path.abspath(script), "--child", tree, *args],
                          capture_output=True, text=True, cwd=tree)
    line = next((x for x in proc.stdout.splitlines() if x.startswith(prefix)), None)
    if proc.returncode != 0 or line is None:
        print(f"{os.path.basename(script)}: the run of {tree} failed (exit {proc.returncode}):\n"
              f"{proc.stderr[-4000:]}", file=sys.stderr)
        return None
    return json.loads(line[len(prefix):])


def spread(xs) -> str:
    """A median and its range."""
    return f"median {statistics.median(xs):.4f} [{min(xs):.4f}-{max(xs):.4f}]"
