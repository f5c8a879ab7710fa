"""The benchmark's one stack generator: multi-neuron arbors in a fluorescence stack.

A traffic file (`benchmark/traffic/<name>.json`) names this generator and
holds its parameters under `"stack"`. Each stack is a pure function of
(`seed`, `index`): the geometry comes from a NumPy generator seeded with
both, the noise from a `torch.Generator` on the stack's device seeded
with a 64-bit word derived from both, so the same pair gives the same
stack on every run.

The recipe is the phantoms' of the repository's tests
(tests/_torch_phantoms.py: a Gaussian cross-section with z scaled by
zdist, an intensity modulated by `0.75 + 0.25 sin(x / 5)`, Gaussian noise
of sd 5, truncated to uint8), grown to several branching arbors and drawn
segment by segment in each segment's own bounding box, combined by
maximum: a whole-volume raster per centerline point, as the phantoms do,
is O(points x voxels) and unusable at 52 Mvox.

An arbor is a binary tree of `depth` levels below its root segment
(2**(depth+1) - 1 segments). A segment runs a length from `seg_len`
voxels (physical length, z scaled by zdist) from its parent's end; its
two children turn by angles from `branch_deg` to either side in the xy
plane, with a small elevation change. The lengths, turns, radii and peaks
of a stack are spread evenly over their ranges and dealt out in an order
drawn from the seed, so every stack holds the same sizes and only the
layout (roots, headings, which arbor is thick or bright) and the noise
change with the seed. A segment that would leave the field reflects off
its wall, so every segment keeps its full length. The gold SWC is the
centerline sampled every voxel, each point's parent the previous one on
its segment or the end of its parent segment.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

#: the voxels kept free at each wall (x, y, z): no centerline comes closer
WALL = (8.0, 8.0, 4.0)


def _seed_words(seed: int, index: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(index)])


def _walk(start, direction, length, dims_xyz, zdist):
    """The segment as straight pieces [(a, b)] in voxel coordinates,
    reflecting off the walls, its end and its final heading; `direction`
    is a physical unit vector."""
    lo = np.array(WALL)
    hi = np.array(dims_xyz, float) - 1.0 - np.array(WALL)
    scale = np.array([1.0, 1.0, 1.0 / zdist])  # physical -> voxel
    pos = np.array(start, float)
    d = np.array(direction, float)
    left = float(length)
    pieces = []
    for _ in range(64):
        if left <= 1e-9:
            break
        step = d * scale  # voxels per unit of physical length
        t_wall, axis = left, -1
        for k in range(3):
            if step[k] > 1e-12:
                t = (hi[k] - pos[k]) / step[k]
            elif step[k] < -1e-12:
                t = (lo[k] - pos[k]) / step[k]
            else:
                continue
            if t < t_wall:
                t_wall, axis = max(t, 0.0), k
        end = pos + step * t_wall
        if t_wall > 1e-9:
            pieces.append((pos.copy(), end.copy()))
        pos = end
        left -= t_wall
        if axis >= 0:
            d[axis] = -d[axis]
    return pieces, pos, d


def _unit(az, el):
    return np.array([math.cos(el) * math.cos(az), math.cos(el) * math.sin(az), math.sin(el)])


def arbor_geometry(p: Dict, seed: int, index: int, zdist: float):
    """The stack's arbors: a list of (pieces, radius, peak) per segment,
    and the gold SWC rows (N, 7): id, type 2, x, y, z, radius, parent."""
    rng = np.random.default_rng(_seed_words(seed, index))
    z, y, x = p["shape"]
    dims = (x, y, z)
    n_arb, depth = int(p["arbors"]), int(p["depth"])
    n_seg = n_arb * (2 ** (depth + 1) - 1)
    # every stack holds the same sizes, spread evenly over their ranges, in
    # an order drawn from the seed: the seed moves the layout, not the work
    radii = iter(rng.permutation(np.linspace(*p["radius"], n_arb)))
    peaks = iter(rng.permutation(np.linspace(*p["peak"], n_arb)))
    lengths = iter(rng.permutation(np.linspace(*p["seg_len"], n_seg)))
    turns = iter(rng.permutation(np.linspace(*p["branch_deg"], n_seg - n_arb)))
    segs, gold = [], []
    for _ in range(n_arb):
        radius = float(next(radii))
        peak = float(next(peaks))
        root = np.array([rng.uniform(WALL[k], dims[k] - 1 - WALL[k]) for k in range(3)])
        az = float(rng.uniform(0.0, 2.0 * math.pi))
        el = math.radians(float(rng.uniform(-p["elevation_deg"], p["elevation_deg"])))
        # (start, azimuth, elevation, level, parent gold id)
        todo = [(root, az, el, 0, -1)]
        while todo:
            start, az, el, level, parent = todo.pop(0)
            length = float(next(lengths))
            pieces, end, d_end = _walk(start, _unit(az, el), length, dims, zdist)
            segs.append((pieces, radius, peak))
            # gold: the centerline every voxel of physical length
            # a root segment emits its start; a child's start is its
            # parent's last point, and a piece's start the previous piece's end
            prev = parent
            for j, (a, b) in enumerate(pieces):
                span = np.linalg.norm((b - a) * np.array([1.0, 1.0, zdist]))
                n = max(1, int(round(span)))
                for k in range(0 if (j == 0 and parent == -1) else 1, n + 1):
                    q = a + (b - a) * (k / n)
                    gold.append([len(gold) + 1, 2, q[0], q[1], q[2], radius, prev])
                    prev = len(gold)
            if level < depth:
                # children turn from the segment's final heading
                az_end = math.atan2(d_end[1], d_end[0])
                el_end = math.asin(max(-1.0, min(1.0, d_end[2])))
                for side in (1.0, -1.0):
                    turn = math.radians(float(next(turns)))
                    de = math.radians(float(rng.uniform(-p["elevation_jitter_deg"],
                                                        p["elevation_jitter_deg"])))
                    cap = math.radians(p["elevation_deg"])
                    todo.append((end, az_end + side * turn,
                                 max(-cap, min(cap, el_end + de)), level + 1, prev))
    return segs, np.asarray(gold, np.float64).reshape(-1, 7)


def _draw_piece(vol, a, b, radius, peak, zdist, p):
    """Max the piece's tube into `vol` (Z, Y, X) float32, in the piece's
    bounding box grown by 3 radii (z: 3 radii / zdist)."""
    z, y, x = vol.shape
    rz = 3.0 * radius / zdist + 1.0
    rxy = 3.0 * radius + 1.0
    lo = np.floor(np.minimum(a, b) - [rxy, rxy, rz]).astype(int)
    hi = np.ceil(np.maximum(a, b) + [rxy, rxy, rz]).astype(int)
    x0, y0, z0 = np.maximum(lo, 0)
    x1, y1, z1 = np.minimum(hi + 1, [x, y, z])
    if x1 <= x0 or y1 <= y0 or z1 <= z0:
        return
    dev = vol.device
    zz = torch.arange(z0, z1, device=dev, dtype=torch.float32).view(-1, 1, 1)
    yy = torch.arange(y0, y1, device=dev, dtype=torch.float32).view(1, -1, 1)
    xx = torch.arange(x0, x1, device=dev, dtype=torch.float32).view(1, 1, -1)
    # distance to the piece in physical units (z scaled by zdist)
    ab = torch.tensor([(b[0] - a[0]), (b[1] - a[1]), (b[2] - a[2]) * zdist], device=dev)
    px, py, pz = xx - float(a[0]), yy - float(a[1]), (zz - float(a[2])) * zdist
    den = float((ab * ab).sum())
    t = (px * ab[0] + py * ab[1] + pz * ab[2]) / max(den, 1e-12)
    t = t.clamp(0.0, 1.0)
    d2 = (px - t * ab[0]) ** 2 + (py - t * ab[1]) ** 2 + (pz - t * ab[2]) ** 2
    amp = peak * (p["mod_base"] + p["mod_amp"] * torch.sin(xx / p["mod_period"]))
    val = amp * torch.exp(-d2 / (2.0 * radius * radius))
    box = vol[z0:z1, y0:y1, x0:x1]
    torch.maximum(box, val, out=box)


def make_stack(p: Dict, seed: int, index: int, zdist: float, device) -> Tuple[torch.Tensor, np.ndarray]:
    """One stack as a (Z, Y, X) uint8 tensor on `device`, and its gold SWC."""
    segs, gold = arbor_geometry(p, seed, index, zdist)
    vol = torch.zeros(tuple(p["shape"]), dtype=torch.float32, device=device)
    for pieces, radius, peak in segs:
        for a, b in pieces:
            _draw_piece(vol, a, b, radius, peak, zdist, p)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(_seed_words(seed, index).generate_state(1, np.uint64)[0]) >> 1)
    noise = torch.randn(vol.shape, generator=gen, device=device, dtype=torch.float32)
    vol.add_(float(p["background"])).add_(noise, alpha=float(p["noise_sd"]))
    return vol.clamp_(0.0, 255.0).to(torch.uint8), gold


def make_pool(p: Dict, seed: int, n: int, zdist: float, device) -> Tuple[list, list]:
    """`n` stacks (indices 0..n-1) made on `device`, each copied to the
    host as a loaded stack would be: (uint8 arrays, gold SWCs)."""
    vols, golds = [], []
    for i in range(n):
        v, g = make_stack(p, seed, i, zdist, device)
        vols.append(v.cpu().numpy())
        golds.append(g)
    return vols, golds
