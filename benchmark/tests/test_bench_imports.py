"""No file of the benchmark imports JAX or the JAX package; the reference
imports nothing of the program."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "pnr_tpu"}


def _tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _files(sub=""):
    root = os.path.join(BENCH, sub)
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_files()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "pnr_tpu_torch" not in set(_tops(path))


def test_the_names_compare_whole():
    assert "pnr_tpu_torch".split(".")[0] not in FORBIDDEN
