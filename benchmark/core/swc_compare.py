"""SWC comparison (DIADEM-style node matching), frozen for the benchmark.

A copy of pnr_tpu_torch/utils/swc_compare.py as it stood when the
benchmark was defined: the yardstick of `swc_f1` must not move with later
changes to the program. Greedy mutual-nearest node matching within a
distance, after arclength resampling of both trees, gives precision,
recall and F1 over node positions.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SwcScore:
    precision: float
    recall: float
    f1: float
    topology: float  # fraction of matched edges consistent with gold
    n_test: int
    n_gold: int
    n_matched: int


def _nodes_and_parents(swc: np.ndarray):
    ids = swc[:, 0].astype(int)
    pos = swc[:, 2:5]
    parents = swc[:, 6].astype(int)
    # one row per unique id (first occurrence; ids may repeat per link)
    _, first = np.unique(ids, return_index=True)
    id_to_row = {int(ids[i]): i for i in first}
    return ids, pos, parents, first, id_to_row


def resample_swc(swc: np.ndarray, spacing: float) -> np.ndarray:
    """Arclength-resample an SWC morphology: every maximal unbranched
    path (between roots / branch points / leaves) is re-walked and
    emitted at uniform `spacing`, independent of its original node
    density.

    One-to-one node matching between reconstructions with different
    node densities systematically understates recall (a tree with fewer
    nodes than the gold cannot match every gold node even at perfect
    geometry); resampling both sides to a common spacing makes the
    match density-invariant — the standard DIADEM preprocessing step.
    """
    ids = swc[:, 0].astype(int)
    pos = swc[:, 2:5]
    parents = swc[:, 6].astype(int)
    _, first = np.unique(ids, return_index=True)
    node_pos = {int(ids[i]): pos[i] for i in first}
    node_row = {int(ids[i]): swc[i] for i in first}
    # Undirected link graph over unique node ids, built from ALL rows:
    # the reference plugin and io/swc.save_nodelist emit ONE ROW PER
    # LINK (node ids repeat, each occurrence carrying one neighbour in
    # the parent column), so taking each node's first-row parent only
    # would turn bidirectional links into parent 2-cycles — rootless,
    # chain-less, and walked twice in opposite directions.
    adj: dict = {n: [] for n in node_pos}
    seen_edges = set()
    for r in range(len(swc)):
        nid, par = int(ids[r]), int(parents[r])
        if par <= 0 or par == nid or par not in node_pos or nid not in node_pos:
            continue
        e = (nid, par) if nid < par else (par, nid)
        if e in seen_edges:
            continue
        seen_edges.add(e)
        adj[nid].append(par)
        adj[par].append(nid)

    # critical nodes = chain endpoints: isolated (deg 0), tips/roots
    # (deg 1), branch points (deg >= 3); interior chain nodes have deg 2
    critical = {n for n in node_pos if len(adj[n]) != 2}
    rows = []
    next_id = [1]
    emitted: dict = {}

    def emit(p, proto, parent_new):
        rows.append(
            np.array([next_id[0], proto[1], p[0], p[1], p[2], proto[5], parent_new])
        )
        next_id[0] += 1
        return next_id[0] - 1

    # emit critical nodes first (parents fixed up after)
    for n in sorted(critical):
        emitted[n] = emit(node_pos[n], node_row[n], -1)

    def walk_and_emit(c, k):
        """Emit the resampled chain c -> k -> ... -> endpoint; returns
        the endpoint node id (critical, or c again for a pure cycle)."""
        poly = [node_pos[c]]
        prev_n, cur = c, k
        for _ in range(len(seen_edges) + 1):
            done.add((prev_n, cur) if prev_n < cur else (cur, prev_n))
            poly.append(node_pos[cur])
            if cur in critical or cur == c:
                break
            nxt = adj[cur][0] if adj[cur][0] != prev_n else adj[cur][1]
            prev_n, cur = cur, nxt
        poly = np.asarray(poly)
        seg = np.linalg.norm(np.diff(poly, axis=0), axis=1)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        total = float(cum[-1])
        n_pts = max(1, int(round(total / spacing)))
        prev = emitted[c]
        for t in range(1, n_pts):
            target = total * t / n_pts
            j = int(np.searchsorted(cum, target, side="right") - 1)
            j = min(j, len(seg) - 1)
            frac = (target - cum[j]) / max(seg[j], 1e-12)
            p = poly[j] + (poly[j + 1] - poly[j]) * frac
            prev = emit(p, node_row[k], prev)
        if cur in emitted:
            erow = rows[emitted[cur] - 1]
            if erow[6] < 0 and cur != c:
                erow[6] = prev
        return cur

    done: set = set()
    for c in sorted(critical):
        for k in sorted(adj[c]):
            e = (c, k) if c < k else (k, c)
            if e not in done:
                walk_and_emit(c, k)
    # pure cycles (every node deg 2) have no critical entry point: open
    # each at its smallest node id
    for e in sorted(seen_edges):
        if e not in done:
            c = e[0]
            if c not in emitted:
                emitted[c] = emit(node_pos[c], node_row[c], -1)
            walk_and_emit(c, e[1])
    return np.asarray(rows, np.float64).reshape(-1, 7)


def compare_swc(
    test: np.ndarray, gold: np.ndarray, dist: float = 4.0, resample: float = 0.0
) -> SwcScore:
    """Score `test` against `gold`; both are (N, 7) SWC row arrays.

    With `resample > 0` both morphologies are arclength-resampled to
    that spacing first (density-invariant matching; see resample_swc).
    """
    if resample > 0:
        test = resample_swc(test, resample)
        gold = resample_swc(gold, resample)
    t_ids, t_pos, t_par, t_first, _ = _nodes_and_parents(test)
    g_ids, g_pos, g_par, g_first, _ = _nodes_and_parents(gold)
    tp = t_pos[t_first]
    gp = g_pos[g_first]
    nt, ng = len(tp), len(gp)
    if nt == 0 or ng == 0:
        return SwcScore(0.0, 0.0, 0.0, 0.0, nt, ng, 0)

    # greedy matching by ascending distance within `dist`, over the
    # SPARSE candidate pair set from a KD-tree (the dense nt x ng matrix
    # is O(n^2) memory — 20 GB for two 50k-node morphologies)
    from scipy.spatial import cKDTree

    pairs = cKDTree(tp).sparse_distance_matrix(
        cKDTree(gp), dist, output_type="coo_matrix"
    )
    matched_t = np.full(nt, -1)
    matched_g = np.full(ng, -1)
    order = np.argsort(pairs.data, kind="stable")
    for i, j in zip(pairs.row[order], pairs.col[order]):
        if matched_t[i] == -1 and matched_g[j] == -1:
            matched_t[i] = j
            matched_g[j] = i

    n_matched = int((matched_t >= 0).sum())
    precision = n_matched / nt
    recall = n_matched / ng
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)

    # topology: for matched test nodes with a parent, the parent's match
    # should be near the gold match's neighbourhood (within 2*dist of it)
    t_id_arr = t_ids[t_first]
    id_to_idx = {int(v): k for k, v in enumerate(t_id_arr)}
    consistent = 0
    total_edges = 0
    t_parent_of = {}
    for r in range(len(test)):
        nid, par = int(t_ids[r]), int(t_par[r])
        if par > 0:
            t_parent_of[nid] = par
    for i in range(nt):
        j = matched_t[i]
        if j < 0:
            continue
        nid = int(t_id_arr[i])
        par = t_parent_of.get(nid)
        if par is None or par not in id_to_idx:
            continue
        pi = id_to_idx[par]
        pj = matched_t[pi]
        if pj < 0:
            continue
        total_edges += 1
        if np.linalg.norm(gp[pj] - gp[j]) <= 2 * dist:
            consistent += 1
    topology = consistent / total_edges if total_edges else 1.0
    return SwcScore(precision, recall, f1, topology, nt, ng, n_matched)
