"""Serving mode: reconstruct stacks as they arrive in a watch directory.

The reference plugin is invoked once per stack from the Vaa3D GUI/CLI
(pnr-vaa3d/Advantra_plugin.cpp:274-337) — every run repays image and
model setup. Production deployment wants a resident process: compiled
trace programs, likelihood tables and the persistent XLA cache live
once, and arriving stacks stream through the prefetch-pipelined batch
driver (`reconstruction_batch`), whose software pipeline overlaps the
next stack's upload/filter/seed front with the current stack's tracing.

File-readiness protocol: a candidate is processed once its size is
stable across two consecutive polls (writers rarely fsync microscopy
stacks atomically); processed inputs are remembered by (path, mtime,
size) so an overwritten file is picked up again. A sentinel file
(default ``.stop``) shuts the loop down after draining queued work.

The port's copy of pnr_tpu/pipeline/serve.py on its own
`reconstruction_batch`, with a `device` ("cuda" unless the caller asks
for the CPU). With a `mesh`, each poll's arrivals run through
`parallel.batch_dp.reconstruction_batch_sharded` (`_watch_sharded`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.io.swc import save_nodelist
from pnr_tpu_torch.io.volume import LOADABLE_EXTS, load_volume
from pnr_tpu_torch.pipeline.reconstruct import reconstruction_batch
from pnr_tpu_torch.utils.exporters import metrics_entry
from pnr_tpu_torch.utils.runtime import require_cuda


#: consecutive polls a processed file must be absent before its `seen`
#: entry is pruned — one missed os.stat (NFS ESTALE, transient hiccup)
#: must NOT make an unchanged, already-processed stack re-enter the
#: pipeline when it reappears with the same (mtime, size) stamp
_PRUNE_AFTER_MISSES = 3


def _scan(watch_dir: str, seen, sizes, missing=None) -> list:
    """Return paths that are new (or rewritten) and stable.

    `sizes` holds each candidate's (mtime_ns, size) awaiting the
    confirming second poll; a file must show the SAME stamp twice in a
    row to be yielded, so a delete+rewrite between polls restarts its
    stability check. Entries for files that vanished are pruned — a
    deleted candidate must not wedge the drain-before-stop check — and
    `seen` entries of files absent for `_PRUNE_AFTER_MISSES` consecutive
    polls are pruned with them, so the long-running server's memory
    stays bounded by the directory size while a single transient stat
    failure cannot trigger a re-reconstruction.
    """
    ready = []
    present = set()
    for name in sorted(os.listdir(watch_dir)):
        path = os.path.join(watch_dir, name)
        if not name.lower().endswith(LOADABLE_EXTS) or not os.path.isfile(path):
            continue
        try:
            st = os.stat(path)
        except OSError:
            continue
        present.add(path)
        key = (path, st.st_mtime_ns, st.st_size)
        if key in seen:
            continue
        stamp = (st.st_mtime_ns, st.st_size)
        if sizes.get(path) == stamp:
            seen.add(key)
            del sizes[path]
            ready.append(path)
        else:
            sizes[path] = stamp  # candidate: confirm next poll
    for stale in [p for p in sizes if p not in present]:
        del sizes[stale]
    if missing is not None:
        for p in {k[0] for k in seen}:
            if p in present:
                missing.pop(p, None)
            else:
                missing[p] = missing.get(p, 0) + 1
        gone = {p for p, n in missing.items() if n >= _PRUNE_AFTER_MISSES}
        seen -= {k for k in seen if k[0] in gone}
        for p in gone:
            del missing[p]
    return ready


def _write_swc(
    result, path: str, out_dir: Optional[str], cfg, verbose,
    metrics_path: Optional[str] = None,
) -> None:
    base = os.path.basename(path) if out_dir else path
    out = (os.path.join(out_dir, base) if out_dir else path) + "_Advantra.swc"
    save_nodelist(
        result.tree, out, ntype=-1, sig2r=1.0, name="Advantra",
        comment=cfg.provenance_comment(),
    )
    if metrics_path:
        # JSON Lines, appended per stack: a resident server must not
        # rewrite an ever-growing array on every reconstruction
        with open(metrics_path, "a") as f:
            f.write(json.dumps(metrics_entry(path, result)) + "\n")
    if verbose:
        print(f"serve: wrote {out} ({len(result.tree) - 1} nodes)")


def watch_and_reconstruct(
    watch_dir: str,
    cfg: PNRConfig,
    out_dir: Optional[str] = None,
    poll_s: float = 1.0,
    stop_file: str = ".stop",
    verbose: bool = True,
    max_stacks: Optional[int] = None,
    mesh=None,
    dp_groups: Optional[int] = None,
    metrics_path: Optional[str] = None,
    *,
    device="cuda",
) -> int:
    """Serve `watch_dir`: reconstruct every arriving stack to SWC.

    Blocks until ``stop_file`` appears inside ``watch_dir`` (or
    ``max_stacks`` inputs have been processed), then drains and
    returns the number of stacks reconstructed. Outputs are written as
    ``<name>_Advantra.swc`` next to the input (or into ``out_dir``).

    With ``metrics_path``, one JSON line of stage timings and counts is
    appended per reconstructed stack (the serving counterpart of the
    CLI's ``--metrics`` single-document dump).

    Every stack runs on ``device`` (the card unless the caller asks for
    the CPU). With ``mesh`` (`parallel.Mesh`, of ``device``'s type),
    arrivals run through the multi-device pipeline instead: each poll's
    batch goes to `parallel.batch_dp.reconstruction_batch_sharded`, which
    splits the mesh into per-stack submeshes: a lone arrival gets the whole
    mesh, a burst runs ``dp_groups`` stacks at once on disjoint groups.
    """
    device = require_cuda(device)
    if mesh is not None and any(d.type != device.type for d in mesh.devices):
        raise ValueError(f"the mesh's devices {mesh.devices} are not of type {device.type!r}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if metrics_path:
        # the JSONL file deliberately appends across server restarts (a
        # resident server must not lose prior runs' records); a run-start
        # line with params + timestamp lets consumers split runs
        with open(metrics_path, "a") as f:
            f.write(
                json.dumps(
                    {
                        "run_start": time.strftime(
                            "%Y-%m-%dT%H:%M:%S", time.gmtime()
                        ),
                        "watch_dir": watch_dir,
                        "params": cfg.provenance_comment(),
                    }
                )
                + "\n"
            )
    seen = set()
    sizes = {}
    missing = {}
    paths = []  # consumed order; reconstruction_batch preserves it
    stop_path = os.path.join(watch_dir, stop_file)

    if mesh is not None:
        return _watch_sharded(
            watch_dir, cfg, mesh, dp_groups, out_dir, poll_s, stop_path,
            verbose, max_stacks, seen, sizes, missing, metrics_path,
        )

    def volumes():
        served = 0
        stop_polls = 0  # polls the stop sentinel has been waiting out
        last_idle = 0.0  # monotonic time of the last not-ready yield
        while max_stacks is None or served < max_stacks:
            got = False
            for path in _scan(watch_dir, seen, sizes, missing):
                try:
                    vol = load_volume(path)
                except Exception as e:  # unreadable/partial: skip loudly
                    if verbose:
                        print(f"serve: skipping {path}: {e}")
                    continue
                paths.append(path)
                got = True
                served += 1
                yield vol
                if max_stacks is not None and served >= max_stacks:
                    return
            if not got:
                # drain before stopping: size-stability needs a second
                # poll, so candidates in `sizes` are still in flight —
                # but a candidate that NEVER stabilizes (a file still
                # being written/appended) must not block shutdown, so
                # pending candidates get a bounded number of extra polls
                if os.path.exists(stop_path):
                    stop_polls += 1
                    if not sizes or stop_polls > 3:
                        return
                else:
                    stop_polls = 0
                # tell the batch driver "nothing ready yet" so it keeps
                # draining queued fronts instead of blocking here — an
                # arrived stack's SWC must never wait on FUTURE arrivals.
                # Throttle only when the driver re-polls FASTER than
                # poll_s (it is idle-spinning); a mid-pipeline top-up
                # that arrives after tracing work gets its None with no
                # sleep on the critical path.
                now = time.monotonic()
                if now - last_idle < poll_s:
                    time.sleep(poll_s - (now - last_idle))
                last_idle = time.monotonic()
                yield None

    count = 0
    for result in reconstruction_batch(volumes(), cfg, verbose=verbose, device=device):
        _write_swc(result, paths[count], out_dir, cfg, verbose, metrics_path)
        count += 1
    return count


def _watch_sharded(
    watch_dir, cfg, mesh, dp_groups, out_dir, poll_s, stop_path,
    verbose, max_stacks, seen, sizes, missing, metrics_path=None,
) -> int:
    """Sharded serving loop: each poll's stable arrivals go through the
    DP x spatial driver as one batch. A stack's streams derive from
    cfg.seed, so serving N stacks equals N `reconstruction_func_sharded`
    runs on a same-size mesh."""
    from pnr_tpu_torch.parallel.batch_dp import reconstruction_batch_sharded

    count = 0
    stop_polls = 0
    while max_stacks is None or count < max_stacks:
        batch = []
        for path in _scan(watch_dir, seen, sizes, missing):
            if max_stacks is not None and count + len(batch) >= max_stacks:
                break
            try:
                vol = load_volume(path)
            except Exception as e:  # unreadable/partial: skip loudly
                if verbose:
                    print(f"serve: skipping {path}: {e}")
                continue
            batch.append((path, vol))
        if not batch:
            # drain before stopping: size-stability needs a second poll,
            # but a never-stabilizing candidate must not block shutdown
            if os.path.exists(stop_path):
                stop_polls += 1
                if not sizes or stop_polls > 3:
                    break
            else:
                stop_polls = 0
            time.sleep(poll_s)
            continue
        results = reconstruction_batch_sharded(
            [v for _, v in batch], cfg, mesh, groups=dp_groups, verbose=verbose)
        for (path, _), result in zip(batch, results):
            _write_swc(result, path, out_dir, cfg, verbose, metrics_path)
            count += 1
    return count
