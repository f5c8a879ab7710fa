#!/usr/bin/env python3
"""The JAX package's names that the port lacks.

    python scripts/torch_name_diff.py [--all]

Parses (with `ast`, importing nothing) every module of `pnr_tpu` and of
`pnr_tpu_torch` and prints, per module of `pnr_tpu`, the public top-level
functions, classes and constants, the public methods of its classes and
the names its `__all__` exports (as `__all__:name`) that the same module
of `pnr_tpu_torch` lacks, and the modules the port has no counterpart of. `--all` also lists private (underscore)
names. ROADMAP.md's "Not ported, by design" names what stays missing on
purpose.
"""

from __future__ import annotations

import ast
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def names(path: str, private: bool) -> set:
    """Top-level defs, classes and assigned names, `Class.method`s, and
    the entries of `__all__` (a package's re-exports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()

    def keep(n):
        return private or not n.startswith("_")

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and keep(node.name):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and keep(node.name):
            out.add(node.name)
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and keep(m.name))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name) and keep(t.id)
                       and t.id != "__all__")
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
                value = node.value
                if isinstance(value, ast.Call):  # list(_EXPORTS)
                    value = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                                 and getattr(n.targets[0], "id", None) == value.args[0].id)
                out.update(f"__all__:{e.value}" for e in getattr(value, "elts", None)
                           or getattr(value, "keys", []))
    return out


def modules(pkg: str) -> dict:
    base = os.path.join(ROOT, pkg)
    found = {}
    for d, _, fs in os.walk(base):
        for f in fs:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), base)[:-3].replace(os.sep, ".")
                found[rel] = os.path.join(d, f)
    return found


def main() -> int:
    private = "--all" in sys.argv[1:]
    ref, port = modules("pnr_tpu"), modules("pnr_tpu_torch")
    missing = 0
    for mod in sorted(ref):
        if mod not in port:
            print(f"{mod}: no module in the port")
            missing += 1
            continue
        lack = sorted(names(ref[mod], private) - names(port[mod], private))
        if lack:
            print(f"{mod}: {', '.join(lack)}")
            missing += len(lack)
    print(f"{missing} missing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
