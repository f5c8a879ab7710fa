"""Module fixtures of the port's tests built once per test run.

Under `pytest -n N --dist load` a module-scoped fixture is built on every
worker that runs one of its tests, so a fixture that runs both pipelines
was paid several times over. `once(tmp_path_factory, name, build)` runs
`build()` in the first worker that asks, pickles its value under the
run's shared base temporary directory, and every other worker waits on
a lock (`fcntl.flock`, the standard library) and loads it. Without
xdist it builds in the run's own base directory. Each worker gets its own
copy of the value; the tests only read it.
"""

import fcntl
import os
import pickle


def once(tmp_path_factory, name: str, build):
    """`build()`'s value, built once per run and shared by the workers."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"torch_once_{name}.pkl"
    with open(root / f"torch_once_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = build()
        tmp = root / f"torch_once_{name}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)
        return value
