"""Checkpoint / resume of a reconstruction in progress.

The reference has no checkpointing (SURVEY.md §5 — its closest analog
is a disabled every-20%-of-seeds mid-result dump). This is a new
capability: after any committed wave the full mutable state — node
arrays, adjacency, visit-count/node-index maps, seed cursor and trace
counter — snapshots to a single .npz; a resumed run continues from the
next wave with identical results (the PRNG streams are keyed per trace
id, so recomputation is deterministic).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from pnr_tpu_torch.graph.build import TraceCommitter
from pnr_tpu_torch.graph.nodes import NodeList


def _nodes_to_arrays(nodes: NodeList) -> dict:
    flat_nbr = []
    nbr_off = [0]
    for nb in nodes.nbr:
        flat_nbr.extend(nb)
        nbr_off.append(len(flat_nbr))
    return {
        "x": np.asarray(nodes.x, np.float32),
        "y": np.asarray(nodes.y, np.float32),
        "z": np.asarray(nodes.z, np.float32),
        "vx": np.asarray(nodes.vx, np.float32),
        "vy": np.asarray(nodes.vy, np.float32),
        "vz": np.asarray(nodes.vz, np.float32),
        "corr": np.asarray(nodes.corr, np.float32),
        "sig": np.asarray(nodes.sig, np.float32),
        "type": np.asarray(nodes.type, np.int32),
        "nbr_flat": np.asarray(flat_nbr, np.int32),
        "nbr_off": np.asarray(nbr_off, np.int64),
    }


def _nodes_from_arrays(d) -> NodeList:
    nodes = NodeList.__new__(NodeList)
    nodes.x = d["x"].astype(float).tolist()
    nodes.y = d["y"].astype(float).tolist()
    nodes.z = d["z"].astype(float).tolist()
    nodes.vx = d["vx"].astype(float).tolist()
    nodes.vy = d["vy"].astype(float).tolist()
    nodes.vz = d["vz"].astype(float).tolist()
    nodes.corr = d["corr"].astype(float).tolist()
    nodes.sig = d["sig"].astype(float).tolist()
    nodes.type = d["type"].astype(int).tolist()
    off = d["nbr_off"]
    flat = d["nbr_flat"]
    nodes.nbr = [flat[off[i] : off[i + 1]].astype(int).tolist() for i in range(len(off) - 1)]
    return nodes


def save_checkpoint(
    path: str,
    committer: TraceCommitter,
    seed_cursor: int,
    trace_count: int,
    pending: Sequence[int] = (),
    nseeds: int = -1,
) -> None:
    """Snapshot the full mutable trace state.

    `pending` is every selected-but-not-yet-traced seed index (lane
    overflow re-queues + the unstarted tail of a wave the trace cap cut
    short) — without it a resume would silently skip those seeds.
    `nseeds` is the run's total seed count, validated at resume. The
    write is uncompressed (the visit maps sit on the tracing critical
    path; zlib costs seconds per wave at production sizes) and atomic
    (temp file + os.replace), so a crash mid-write — the exact event
    checkpointing exists to survive — never corrupts the previous
    snapshot.
    """
    state = _nodes_to_arrays(committer.nodes)
    state.update(
        npervol=committer.npervol,
        nidx=committer.nidx,
        smap=committer.smap if committer.smap is not None else np.zeros(0, np.int32),
        has_smap=np.asarray(committer.smap is not None),
        seed_cursor=np.asarray(seed_cursor, np.int64),
        trace_count=np.asarray(trace_count, np.int64),
        pending=np.asarray(list(pending), np.int64),
        nseeds=np.asarray(nseeds, np.int64),
        vol=np.asarray(committer.vol, np.int32),
        nodepervol=np.asarray(committer.nodepervol, np.int32),
        shape=np.asarray(committer.shape, np.int64),
    )
    tmp = path + ".tmp.npz"
    np.savez(tmp, **state)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[TraceCommitter, int, int, list, int]:
    """Rebuild (committer, seed_cursor, trace_count, pending, nseeds)."""
    d = np.load(path, allow_pickle=False)
    nodes = _nodes_from_arrays(d)
    smap = d["smap"] if bool(d["has_smap"]) else None
    committer = TraceCommitter(
        tuple(int(s) for s in d["shape"]),
        int(d["vol"]),
        int(d["nodepervol"]),
        nodes,
        smap,
    )
    committer.npervol = d["npervol"].copy()
    committer.nidx = d["nidx"].copy()
    pending = d["pending"].tolist() if "pending" in d.files else []
    nseeds = int(d["nseeds"]) if "nseeds" in d.files else -1
    return committer, int(d["seed_cursor"]), int(d["trace_count"]), pending, nseeds
