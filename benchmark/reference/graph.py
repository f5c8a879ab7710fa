"""The graph stage in plain NumPy and torch: from the traced nodes to the tree.

The upstream plugin's `reconstruct` (pnr-vaa3d Advantra_plugin.cpp:2096),
step by step, on plain arrays (positions (N, 3) in voxels, per-node sigma,
corr and soma flag, neighbour lists without the plugin's dummy node 0):

1. resample: every link longer than `trace_rsmpl` gets evenly spaced new
   nodes, sigma and corr interpolated along it (:780-861);
2. non-blurring mean shift: each node moves to the mean (x, y, z, sigma)
   of the ORIGINAL nodes within `sig2radius` times its current sigma, up
   to `refine_iter` times or until it moves by at most sqrt(epsilon2)
   (:968-1052); computed by direct differences in the given dtype;
3. grouping: nodes taken by falling corr (ties by index); each node not
   yet grouped opens a group and absorbs every ungrouped node within
   `group_radius` of its own position; a group sits at the mean of its
   members, and its links are its members' links
   (:1566-1642);
4. a breadth-first forest (nodes in index order seed the trees, isolated
   single nodes dropped), trees under `tree_size_min` nodes dropped, or all
   but the largest with `enforce_single_tree`, tails under `tail_size_min`
   removed with `prune_tails` (:379-699);
5. every parent link split into pieces of at most one voxel (:714-778).

The result is the tree's nodes and its parent links, compared with the
program's tree as point and link sets (`tree_off`).
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Tuple

import numpy as np
import torch

#: elements of one block of the mean shift's difference tensor
_BLOCK_ELEMS = 1 << 25


def resample(xyz, sig, corr, soma, nbr, step):
    """Split every link longer than `step`; returns new arrays and lists
    (new nodes appended in the plugin's order)."""
    xs = [tuple(map(float, p)) for p in xyz]
    sg, cr, sm = list(map(float, sig)), list(map(float, corr)), list(map(bool, soma))
    nb = [list(n) for n in nbr]
    done = [[False] * len(n) for n in nb]
    for i in range(len(xyz)):
        for j in range(len(nb[i])):
            if done[i][j]:
                continue
            i1 = nb[i][j]
            if i not in nb[i1]:
                continue
            j1 = nb[i1].index(i)
            done[i][j] = done[i1][j1] = True
            (x0, y0, z0), (x1, y1, z1) = xs[i], xs[i1]
            norm = math.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2 + (z1 - z0) ** 2)
            if norm == 0.0:
                continue
            n = int(math.ceil(norm / step))
            prev = i
            for k in range(1, n):
                t = k / n
                xs.append((x0 + (x1 - x0) * t, y0 + (y1 - y0) * t, z0 + (z1 - z0) * t))
                sg.append(sg[i] + (sg[i1] - sg[i]) * t)
                cr.append(cr[i] + (cr[i1] - cr[i]) * t)
                sm.append(sm[i] if k <= n // 2 else sm[i1])
                new = len(xs) - 1
                nb.append([prev])
                done.append([True])
                if k == 1:
                    nb[i][j] = new
                else:
                    nb[prev].append(new)
                    done[prev].append(True)
                prev = new
            if n > 1:
                nb[prev].append(i1)
                done[prev].append(True)
                nb[i1][j1] = prev
    return (np.asarray(xs, np.float64).reshape(-1, 3), np.asarray(sg, np.float64),
            np.asarray(cr, np.float64), np.asarray(sm, bool), nb)


def mean_shift(xyz, sig, sig2rad, max_iter, eps2, device, dtype):
    """Non-blurring mean shift of every node over the original nodes."""
    dev = torch.device(device)
    centre = xyz.mean(axis=0)
    pts = torch.from_numpy(xyz - centre).to(dev, dtype)
    p4 = torch.cat([pts, torch.from_numpy(sig).to(dev, dtype)[:, None]], 1)
    conv = p4.clone()
    n = len(xyz)
    rows = max(1, _BLOCK_ELEMS // max(3 * n, 1))
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(int(max_iter)):
        if not bool(active.any()):
            break
        nxt = conv.clone()
        for b in range(0, n, rows):
            c = conv[b:b + rows]
            d2 = ((c[:, None, :3] - pts[None, :, :]) ** 2).sum(-1)
            inside = (d2 <= (sig2rad * c[:, 3:4]) ** 2).to(dtype)
            cnt = inside.sum(1, keepdim=True)
            mean = (inside @ p4) / cnt.clamp(min=1)
            nxt[b:b + rows] = torch.where(cnt > 0, mean, c)
        move2 = ((nxt[:, :3] - conv[:, :3]) ** 2).sum(1)
        conv = torch.where(active[:, None], nxt, conv)
        active &= move2 > eps2
    out = conv.double().cpu().numpy()
    return out[:, :3] + centre, out[:, 3]


def group(xyz, sig, corr, soma, nbr, rad):
    """Greedy grouping; returns the groups' positions and their neighbour
    lists, as the plugin's `check_nbr` leaves them. A group's position is
    the mean of its members."""
    from scipy.spatial import cKDTree

    n = len(xyz)
    group_of = np.full(n, -1, np.int64)
    centres: List[np.ndarray] = []
    for i in np.flatnonzero(soma):
        group_of[i] = len(centres)
        centres.append(xyz[i])
    near = cKDTree(xyz).query_ball_point(xyz, rad, return_sorted=True)
    for ci in np.argsort(-corr.astype(np.float32), kind="stable"):
        if group_of[ci] != -1:
            continue
        cand = np.asarray(near[ci], np.int64)
        members = np.concatenate([[ci], cand[(group_of[cand] == -1) & ~soma[cand] & (cand != ci)]])
        group_of[members] = len(centres)
        centres.append(xyz[members].mean(axis=0))
    links: List[List[int]] = [[] for _ in centres]
    for i in range(n):
        for j in nbr[i]:
            links[group_of[i]].append(int(group_of[j]))
    for g in range(len(links)):
        links[g] = sorted(set(links[g]) - {g})
    for g in range(len(links)):
        for h in links[g]:
            if g not in links[h]:
                links[h].append(g)
    return np.asarray(centres, np.float64).reshape(-1, 3), links


def forest(nbr) -> Tuple[List[int], List[int], List[int]]:
    """Breadth-first forest: (node order, parent position in that order or
    -1, tree id) over the kept nodes; isolated single nodes dropped."""
    n = len(nbr)
    seen = np.zeros(n, bool)
    order, parent, tree = [], [], []
    pos = np.full(n, -1, np.int64)
    from_ = np.full(n, -1, np.int64)
    trees = 0
    for s in range(n):
        if seen[s]:
            continue
        seen[s] = True
        q = deque([s])
        first = True
        while q:
            cur = q.popleft()
            for a in nbr[cur]:
                if not seen[a]:
                    seen[a] = True
                    from_[a] = cur
                    q.append(a)
            if first and not q:
                break  # an isolated node
            first = False
            pos[cur] = len(order)
            order.append(cur)
            parent.append(int(pos[from_[cur]]) if from_[cur] >= 0 else -1)
            tree.append(trees)
        trees += 1
    return order, parent, tree


def _remove_tails(parent, min_size):
    n = len(parent)
    adj: List[List[int]] = [[] for _ in range(n)]
    for i, p in enumerate(parent):
        if p >= 0:
            adj[i].append(p)
            adj[p].append(i)
    drop = np.zeros(n, bool)
    for i in range(n):
        if len(adj[i]) != 1:
            continue
        tail, nxt = [i], adj[i][0]
        while len(adj[nxt]) == 2:
            tail.append(nxt)
            a, b = adj[nxt]
            nxt = b if a == tail[-2] else a
        if len(adj[nxt]) > 2 and len(tail) < min_size:
            drop[tail] = True
    return ~drop


def _subset(pos, par, keep):
    """The kept nodes; a link to a dropped node is dropped."""
    idx = np.flatnonzero(keep)
    new = np.full(len(keep), -1, np.int64)
    new[idx] = np.arange(len(idx))
    p = par[idx]
    return pos[idx], np.where(p >= 0, new[np.maximum(p, 0)], -1)


def tree_of(nodes: np.ndarray, nbr, cfg, device, dtype=torch.float64):
    """The tree made from the traced nodes: (positions (M, 3), parent
    index or -1 per node). `nodes` holds x, y, z, corr, sig and a soma
    flag per row; `nbr` the traced links (0-based)."""
    if len(nodes) == 0:
        return np.zeros((0, 3)), np.zeros(0, np.int64)
    xyz, sig, corr, soma, nb = resample(nodes[:, 0:3], nodes[:, 4], nodes[:, 3],
                                        nodes[:, 5] > 0, nbr, cfg.trace_rsmpl)
    xyz, _ = mean_shift(xyz, sig, cfg.sig2radius, cfg.refine_iter, cfg.epsilon2, device, dtype)
    gxyz, links = group(xyz, sig, corr, soma, nb, cfg.group_radius)
    order, parent, tree = forest(links)
    if not order:
        return np.zeros((0, 3)), np.zeros(0, np.int64)
    sizes = np.bincount(tree)
    if cfg.enforce_single_tree:
        keep = np.asarray(tree) == int(np.argmax(sizes))
    else:
        keep = sizes[tree] >= cfg.tree_size_min
    pos, par = _subset(gxyz[order], np.asarray(parent, np.int64), keep)
    if cfg.prune_tails:
        pos, par = _subset(pos, par, _remove_tails(par, cfg.tail_size_min))
    # each parent link split into pieces of at most one voxel
    out, outp = list(pos), list(par)
    for i in range(len(pos)):
        if par[i] < 0:
            continue
        d = pos[par[i]] - pos[i]
        k_n = int(math.ceil(math.sqrt(float(np.dot(d, d)))))
        prev = i
        for k in range(1, k_n):
            out.append(pos[i] + d * (k / k_n))
            outp.append(-1)
            outp[prev] = len(out) - 1
            prev = len(out) - 1
        if k_n > 1:
            outp[prev] = int(par[i])
    return np.asarray(out, np.float64).reshape(-1, 3), np.asarray(outp, np.int64)


def tree_off(a_xyz, a_par, b_xyz, b_par, tol) -> float:
    """Nodes and links in one tree only, over tree `b`'s nodes and links:
    a node is in both where the other tree has a node within `tol`
    voxels; a link where both its ends are and the other tree links them."""
    from scipy.spatial import cKDTree

    def one_way(x, par, y, ypar):
        if len(x) == 0:
            return 0, 0
        if len(y) == 0:
            return len(x), int(np.sum(par >= 0))
        d, m = cKDTree(y).query(x, k=1)
        hit = d <= tol
        links = {(int(c), int(p)) for c, p in enumerate(ypar) if p >= 0}
        links |= {(p, c) for c, p in links}
        miss_links = 0
        for c, p in enumerate(par):
            if p < 0:
                continue
            if not (hit[c] and hit[p] and (int(m[c]), int(m[p])) in links):
                miss_links += 1
        return int(np.sum(~hit)), miss_links

    na, la = one_way(a_xyz, a_par, b_xyz, b_par)
    nb, lb = one_way(b_xyz, b_par, a_xyz, a_par)
    total = len(b_xyz) + int(np.sum(b_par >= 0))
    return (na + la + nb + lb) / max(total, 1)
