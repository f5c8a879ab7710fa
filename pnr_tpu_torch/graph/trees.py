"""Tree extraction and pruning over the grouped node graph.

Parity targets (pnr-vaa3d/Advantra_plugin.cpp):
* `bfs2` (:379-478) — BFS forest over the bidirectional graph: output
  treelist where each node keeps at most one parent link in nbr[0];
  non-soma nodes are recolored per tree (type = treecnt + 2); isolated
  single nodes are dropped;
* `extract_largest_tree` (:546-589) / `extract_trees` (:591-629);
* `remove_tails` (:631-699);
* `interpolate_treelist` (:714-778).

Node counts are O(1e4-1e5); these run on host (SURVEY.md §7 step 4).
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np

from pnr_tpu_torch.graph.nodes import SOMA, NodeList


def bfs_forest(nodes: NodeList, remove_isolated: bool = True) -> NodeList:
    """BFS tree extraction (bfs2). Returns a treelist NodeList."""
    n = len(nodes)
    dist = [np.iinfo(np.int32).max] * n
    nmap = [-1] * n
    parent = [-1] * n
    dist[0] = -1

    tree = NodeList()
    treecnt = 0

    def next_seed():
        for i in range(1, n):
            if dist[i] == np.iinfo(np.int32).max:
                return i
        return -1

    while True:
        seed = next_seed()
        if seed < 0:
            break
        treecnt += 1
        dist[seed] = 0
        q = deque([seed])
        nodes_in_tree = 0
        while q:
            cur = q.popleft()
            ntype = nodes.type[cur]
            if ntype != SOMA:
                ntype = treecnt + 2  # per-tree recoloring (bfs2 :444)
            nid = tree.add(
                nodes.x[cur], nodes.y[cur], nodes.z[cur],
                nodes.vx[cur], nodes.vy[cur], nodes.vz[cur],
                corr=nodes.corr[cur], sig=nodes.sig[cur], ntype=ntype,
            )
            if parent[cur] > 0:
                tree.nbr[nid].append(nmap[parent[cur]])
            nmap[cur] = nid
            nodes_in_tree += 1
            for adj in nodes.nbr[cur]:
                if dist[adj] == np.iinfo(np.int32).max:
                    dist[adj] = dist[cur] + 1
                    parent[adj] = cur
                    q.append(adj)
            if nodes_in_tree == 1 and not q and remove_isolated:
                # drop isolated single node (bfs2 :467-470)
                tree.x.pop(); tree.y.pop(); tree.z.pop()
                tree.vx.pop(); tree.vy.pop(); tree.vz.pop()
                tree.corr.pop(); tree.sig.pop(); tree.type.pop(); tree.nbr.pop()
                nmap[cur] = -1
    return tree


def _tree_spans(tree: NodeList) -> List[tuple]:
    """[(beg, end)) index ranges of the trees in a treelist (roots have no nbr)."""
    spans = []
    root_prev = root_curr = 1
    n = len(tree)
    for i in range(1, n + 1):
        if i == n or len(tree.nbr[i]) == 0:
            root_prev, root_curr = root_curr, i
            if root_curr > root_prev:
                spans.append((root_prev, root_curr))
    return spans


def _subset_treelist(tree: NodeList, keep: np.ndarray) -> NodeList:
    """Concatenate kept nodes, remapping parent links (keep[0] implied)."""
    x2y = np.full(len(tree), -1, np.int64)
    out = NodeList()
    for i in range(1, len(tree)):
        if keep[i]:
            x2y[i] = len(out)
            out.add(
                tree.x[i], tree.y[i], tree.z[i],
                tree.vx[i], tree.vy[i], tree.vz[i],
                corr=tree.corr[i], sig=tree.sig[i], ntype=tree.type[i],
            )
            out.nbr[-1] = list(tree.nbr[i])
    for i in range(1, len(out)):
        # drop links to removed nodes: an unmapped j (-1) must not leak
        # into nbr, where Python negative indexing would silently alias
        # the LAST node (current callers keep whole tree spans, so links
        # only sever if a caller ever passes a partial-span mask)
        out.nbr[i] = [int(x2y[j]) for j in out.nbr[i] if x2y[j] >= 0]
    return out


def extract_largest_tree(tree: NodeList) -> NodeList:
    spans = _tree_spans(tree)
    if not spans:
        return NodeList()
    beg, end = max(spans, key=lambda s: s[1] - s[0])
    keep = np.zeros(len(tree), bool)
    keep[beg:end] = True
    return _subset_treelist(tree, keep)


def extract_trees(tree: NodeList, min_size: int) -> NodeList:
    keep = np.ones(len(tree), bool)
    for beg, end in _tree_spans(tree):
        if end - beg < min_size:
            keep[beg:end] = False
    return _subset_treelist(tree, keep)


def remove_tails(tree: NodeList, min_size: int) -> NodeList:
    """Remove endpoint-to-junction tails shorter than min_size
    (Advantra_plugin.cpp:631-699)."""
    n = len(tree)
    # bidirectional copy of the parent links
    nbr2 = [list(t) for t in tree.nbr]
    for i in range(1, n):
        for j in tree.nbr[i]:
            nbr2[j].append(i)

    remove = np.zeros(n, bool)
    for i in range(1, n):
        if len(nbr2[i]) == 1:  # endpoint
            tail = [i]
            nxt = nbr2[i][0]
            while len(nbr2[nxt]) == 2:
                tail.append(nxt)
                a, b = nbr2[nxt]
                nxt = b if a == tail[-2] else a
            if len(nbr2[nxt]) > 2 and len(tail) < min_size:
                for t in tail:
                    remove[t] = True

    x2y = np.full(n, -1, np.int64)
    out = NodeList()
    for i in range(1, n):
        if not remove[i]:
            x2y[i] = len(out)
            out.add(
                tree.x[i], tree.y[i], tree.z[i],
                tree.vx[i], tree.vy[i], tree.vz[i],
                corr=tree.corr[i], sig=tree.sig[i], ntype=tree.type[i],
            )
            out.nbr[-1] = list(tree.nbr[i])
    for i in range(1, len(out)):
        out.nbr[i] = [int(x2y[j]) for j in out.nbr[i] if not remove[j]]
    return out


def interpolate_treelist(tree: NodeList, step: float, ntype: int = -1) -> None:
    """Insert nodes so each parent link is at most `step` long; re-type
    non-soma nodes when ntype >= 0 (Advantra_plugin.cpp:714-778)."""
    init_size = len(tree)
    for i in range(1, init_size):
        if ntype >= 0 and tree.type[i] != SOMA:
            tree.type[i] = ntype
        for j in range(len(tree.nbr[i])):
            i1 = tree.nbr[i][j]
            dx = tree.x[i1] - tree.x[i]
            dy = tree.y[i1] - tree.y[i]
            dz = tree.z[i1] - tree.z[i]
            vnorm = float(np.sqrt(dx * dx + dy * dy + dz * dz))
            if vnorm == 0:
                continue
            vx, vy, vz = dx / vnorm, dy / vnorm, dz / vnorm
            nseg = int(np.ceil(vnorm / step))
            for k in range(1, nseg):
                t = k / float(nseg)
                nid = tree.add(
                    tree.x[i] + k * (vnorm / nseg) * vx,
                    tree.y[i] + k * (vnorm / nseg) * vy,
                    tree.z[i] + k * (vnorm / nseg) * vz,
                    vx, vy, vz,
                    corr=tree.corr[i] + (tree.corr[i1] - tree.corr[i]) * t,
                    sig=tree.sig[i] + (tree.sig[i1] - tree.sig[i]) * t,
                    ntype=tree.type[i] if k <= nseg // 2 else tree.type[i1],
                )
                if k == 1:
                    tree.nbr[i][j] = nid
                else:
                    tree.nbr[nid - 1].append(nid)
                if k == nseg - 1:
                    tree.nbr[nid].append(i1)
