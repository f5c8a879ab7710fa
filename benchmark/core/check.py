"""The comparison that decides `correct`: the program's outputs against the plain reference.

For each stack of the sample, the reference (benchmark/reference/, plain
torch, nothing of the program) works out again from the stack itself:

* the filter's J8 and quantized directions (`frangi_j8`);
* the seeds: the per-slice maxima of its own J8, scored at its own decoded
  directions with the cell's likelihood (exact templates or tube maps) and
  kept at corr >= znccth;
* the likelihood at each raw node the tracer committed, at the node's own
  position and direction;
* the graph stage (benchmark/reference/graph.py) from the program's traced
  nodes and links to the tree, in float64.

The numbers compared (each the worst over the sampled stacks):

  j8_off          share of voxels where the program's J8 and the
                  reference's differ by more than 1
  seed_set_off    |program seeds xor reference seeds| / |reference seeds|
  seed_corr_gap   widest |corr| gap at the seeds both hold
  node_corr_off   share of the tracer's nodes whose corr lies more than
                  NODE_CORR_TOL from the reference's (a share, not the
                  widest gap: where a trace's particle cloud splits over
                  two branches, its centroid falls outside the window the
                  program samples it in, and the program's clamped samples
                  rightly differ from the reference's free ones)
  node_sig_off    share of nodes whose radius sigma differs
  node_step_off   share of a trace's steps that moved less than a quarter
                  of `step` (a stage that returns its state unchanged)
  order_off       count of broken invariants: seeds not sorted by falling
                  corr or under znccth, nodes under znccth, tree links to
                  no node or to the node itself (exact: limit 0)
  tree_off        nodes and links in one tree only (the program's, or the
                  reference's from the program's traced nodes), over the
                  reference tree's nodes and links; a node is in both
                  where the other tree has one within TREE_TOL voxels

and, over all the window's stacks (run.py):

  f1_short        1 - swc_f1: the share of the generator's gold that the
                  window's trees miss, DIADEM-style, pooled

The tracer's random draws are not derived again: the reference checks each
estimate the draws led to, where the tracer committed it, and the tree
that the graph stage makes of them; where the tracer went is held by
f1_short against the gold.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.flood import maxima
from benchmark.reference.frangi import decode_dirs, frangi_j8
from benchmark.reference.graph import tree_of, tree_off
from benchmark.reference.zncc import Exact, Tube

#: the numbers of one stack
NUMBERS = ("j8_off", "seed_set_off", "seed_corr_gap", "node_corr_off", "node_sig_off",
           "node_step_off", "order_off", "tree_off")
#: every number compared, the window's last
ALL = NUMBERS + ("f1_short",)
#: a node's corr is off when it lies this far from the reference's
NODE_CORR_TOL = 1e-3
#: a tree node is in both trees where the other has one this close, voxels
TREE_TOL = 0.1
#: the SWC type of a soma node
SOMA = 1


class Outputs:
    """What the program produced for one stack, as plain host arrays."""

    def __init__(self, j8, seeds_pos, seeds_corr, nodes, links, tree_xyz, tree_par,
                 tree_nbr=()):
        self.j8 = j8  # (Z, Y, X) uint8
        self.seeds_pos = np.asarray(seeds_pos, np.float32).reshape(-1, 3)
        self.seeds_corr = np.asarray(seeds_corr, np.float32).reshape(-1)
        # (N, 10): x, y, z, vx, vy, vz, corr, sig, type, is_step (linked to
        # the node before it in its trace)
        self.nodes = np.asarray(nodes, np.float64).reshape(-1, 10)
        self.links = links  # the traced nodes' neighbour lists, 0-based
        # the final tree: positions (M, 3), each node's parent or -1
        self.tree_xyz = np.asarray(tree_xyz, np.float64).reshape(-1, 3)
        self.tree_par = np.asarray(tree_par, np.int64).reshape(-1)
        self.tree_nbr = tree_nbr  # the tree's links as the program lists them


def outputs_of(result) -> Outputs:
    """The outputs of a ReconstructionResult (the program's own fields)."""
    n0 = result.n0
    idx = np.arange(1, len(n0))
    typ = np.asarray(n0.type, np.float64)[1:]
    # the tracer links each committed step to the node before it
    step = np.array([float(i - 1 in n0.nbr[i]) if typ[k] == 2 else 0.0
                     for k, i in enumerate(idx)])
    cols = [np.asarray(getattr(n0, f), np.float64)[1:] for f in
            ("x", "y", "z", "vx", "vy", "vz", "corr", "sig")]
    nodes = np.stack(cols + [typ, step], axis=1) if len(idx) else np.zeros((0, 10))
    links = [[j - 1 for j in n0.nbr[i] if j > 0] for i in idx]
    tree = result.tree
    tree_xyz = np.stack([np.asarray(getattr(tree, f), np.float64)[1:] for f in "xyz"], 1)
    tree_par = [nb[0] - 1 if nb else -1 for nb in tree.nbr[1:]]
    return Outputs(result.j8, result.seeds_pos, result.seeds_corr, nodes, links, tree_xyz,
                   tree_par, [list(nb) for nb in tree.nbr])


def graph_input(out: Outputs) -> np.ndarray:
    """The traced nodes as the graph reference takes them: x, y, z, corr,
    sig and the soma flag."""
    nd = out.nodes
    return np.concatenate([nd[:, [0, 1, 2, 6, 7]], (nd[:, 8:9] == SOMA)], 1)


class Reference:
    """The plain reference for one configuration, in `dtype`."""

    def __init__(self, cfg, device, dtype=torch.float32):
        self.cfg, self.dev, self.dtype = cfg, torch.device(device), dtype
        self.tube = cfg.zncc_mode == "tube"
        self._last = (None, None)  # the last stack's front, kept for a second comparison

    def likelihood(self, vol):
        """(pos, dirs) -> (corr, sig) on this stack."""
        if self.tube:
            eng = Tube(self.cfg.sigmas, self.dtype)
            eng.build(vol)
            return lambda p, d: eng(p, d)
        eng = Exact(self.cfg.sigmas, self.dtype)
        return lambda p, d: eng(vol, p, d)

    def front(self, vol_np):
        """(vol, J8, quantized directions, likelihood, seeds (N, 3) xyz,
        their corr) of the reference, selected at znccth and sorted."""
        if self._last[0] is vol_np:
            return self._last[1]
        self._last = (None, None)
        cfg = self.cfg
        vol = torch.from_numpy(np.ascontiguousarray(vol_np)).to(self.dev)
        j8, qd = frangi_j8(vol, cfg.sigmas, cfg.zdist, cfg.frangi_alpha, cfg.frangi_beta,
                           cfg.frangi_c, self.dtype)
        m = maxima(j8, cfg.tolerance)
        z, y, x = torch.nonzero(m, as_tuple=True)
        xyz = torch.stack([x, y, z], 1)
        lik = self.likelihood(vol)
        corr, _ = lik(xyz.float(), decode_dirs(qd, xyz))
        keep = corr >= cfg.znccth
        self._last = (vol_np, (vol, j8, qd, lik, xyz[keep].float(), corr[keep]))
        return self._last[1]

    def graph_dtype(self):
        """The graph stage's dtype: float64 for the float32 reference, the
        lower dtype itself for a control."""
        return torch.float64 if self.dtype == torch.float32 else self.dtype

    def outputs(self, vol_np, prog: Outputs) -> Outputs:
        """The reference put in the program's place (the control, in a lower
        dtype): its J8, its seeds, its likelihood at the program's traced
        nodes, and the tree its graph stage makes of them."""
        _, j8, _, lik, seeds, corr = self.front(vol_np)
        order = torch.argsort(-corr, stable=True)
        nodes = prog.nodes
        out = nodes.copy()
        if len(nodes):
            p = torch.from_numpy(nodes[:, 0:3]).float().to(self.dev)
            d = torch.from_numpy(nodes[:, 3:6]).float().to(self.dev)
            c, s = lik(p, d)
            out[:, 6], out[:, 7] = c.cpu().numpy(), s.cpu().numpy()
        txyz, tpar = tree_of(graph_input(prog), prog.links, self.cfg, self.dev, self.graph_dtype())
        return Outputs(j8.cpu().numpy(), seeds[order].cpu().numpy(),
                       corr[order].cpu().numpy(), out, prog.links, txyz, tpar)

    def compare(self, vol_np, out: Outputs) -> Dict[str, float]:
        cfg = self.cfg
        vol, j8, qd, lik, seeds, corr = self.front(vol_np)
        nums: Dict[str, float] = {}
        if out.j8 is None:
            return {k: float("inf") for k in NUMBERS}
        jp = torch.from_numpy(np.ascontiguousarray(out.j8)).to(self.dev)
        nums["j8_off"] = float(((jp.int() - j8.int()).abs() > 1).float().mean())
        ref = {tuple(p): float(c) for p, c in zip(seeds.round().long().cpu().tolist(),
                                                  corr.cpu().tolist())}
        prog = {tuple(int(round(v)) for v in p): float(c)
                for p, c in zip(out.seeds_pos.tolist(), out.seeds_corr.tolist())}
        both = prog.keys() & ref.keys()
        nums["seed_set_off"] = len(prog.keys() ^ ref.keys()) / max(len(ref), 1)
        nums["seed_corr_gap"] = max((abs(prog[k] - ref[k]) for k in both), default=0.0)
        nd = out.nodes
        if len(nd):
            p = torch.from_numpy(nd[:, 0:3]).float().to(self.dev)
            d = torch.from_numpy(nd[:, 3:6]).float().to(self.dev)
            c, s = lik(p, d)
            c, s = c.cpu().numpy(), s.cpu().numpy()
            nums["node_corr_off"] = float(np.mean(np.abs(nd[:, 6] - c) > NODE_CORR_TOL))
            nums["node_sig_off"] = float(np.mean(np.abs(nd[:, 7] - s) > 1e-6))
            steps = np.flatnonzero(nd[:, 9] > 0)
            dz = np.array([1.0, 1.0, cfg.zdist])
            moved = np.linalg.norm((nd[steps, 0:3] - nd[steps - 1, 0:3]) * dz, axis=1)
            nums["node_step_off"] = float(np.mean(moved < 0.25 * cfg.step)) if len(steps) else 0.0
        else:
            nums.update(node_corr_off=0.0, node_sig_off=0.0, node_step_off=0.0)
        bad = int(np.sum(np.diff(out.seeds_corr) > 0)) + int(np.sum(out.seeds_corr < cfg.znccth))
        if len(nd):
            bad += int(np.sum(nd[:, 6] < cfg.znccth))
        nb = out.tree_nbr
        bad += sum(1 for i, lst in enumerate(nb) for j in lst if not 0 < j < len(nb) or j == i)
        nums["order_off"] = float(bad)
        rxyz, rpar = tree_of(graph_input(out), out.links, cfg, self.dev, self.graph_dtype())
        nums["tree_off"] = tree_off(out.tree_xyz, out.tree_par, rxyz, rpar, TREE_TOL)
        return nums


def sample(order_key: List[int], n: int, seed: int) -> List[int]:
    """`n` stack positions drawn from the seed, the longest first:
    `order_key` is each completed stack's raw node count."""
    if not order_key:
        return []
    longest = int(np.argmax(order_key))
    rest = [i for i in range(len(order_key)) if i != longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, 7]))
    pick = list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False)) if rest else []
    return [longest] + [int(i) for i in pick]


def worst(per_stack: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(d[k] for d in per_stack) for k in NUMBERS} if per_stack else {}


def f1_short(matched: int, traced: int, gold: int) -> float:
    """1 - F1 of `matched` nodes among `traced` and `gold` ones."""
    return 1.0 - 2.0 * matched / max(traced + gold, 1)
