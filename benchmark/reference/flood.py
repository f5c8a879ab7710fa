"""Plain per-slice maxima with a tolerance (ImageJ MaximumFinder, MAX_POINT output).

The seed rule of the upstream plugin (seed.cpp's MaximumFinder) in plain
torch operations, as a parallel label propagation over all slices at once:

* a candidate is an interior pixel at least as bright as its 8
  neighbours and brighter than its slice's minimum; its claim is
  (value << 24 | offset in the slice), so brighter, then later, wins;
* claims spread to 8-neighbours: a claim of value v0 may enter a pixel
  of value v when v <= v0 <= v + tolerance, and each pixel keeps the
  largest claim that may enter it, until nothing changes;
* a region dies when one of its pixels touches the slice border, has a
  neighbour brighter than v0, or has a neighbour holding a larger claim;
* a surviving region marks the pixel of value v0 nearest the centroid of
  its pixels of value v0 (ties: the largest offset).

The program's native flood is the sequential algorithm; on cascading
kills the two may disagree on a few seeds (the program's notes give
divergence within 2 px). `benchmark/reference/` compares seed sets with a
limit set from that.
"""

from __future__ import annotations

import torch

_SHIFT = 24


def _neighbours(padded: torch.Tensor, h: int, w: int):
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                yield padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _pad(x: torch.Tensor, fill) -> torch.Tensor:
    z, h, w = x.shape
    p = x.new_full((z, h + 2, w + 2), fill)
    p[:, 1:-1, 1:-1] = x
    return p


def _nbmax(x: torch.Tensor, fill) -> torch.Tensor:
    z, h, w = x.shape
    out = None
    for s in _neighbours(_pad(x, fill), h, w):
        out = s.clone() if out is None else torch.maximum(out, s)
    return out


def maxima(j8: torch.Tensor, tolerance: float) -> torch.Tensor:
    """(Z, Y, X) bool mask of each slice's maxima of uint8 `j8`."""
    z, h, w = j8.shape
    dev = j8.device
    v = j8.to(torch.int64)
    tol = int(tolerance)
    gmin = v.reshape(z, -1).amin(dim=1).view(z, 1, 1)
    nb = _nbmax(v, -1)
    yy = torch.arange(h, device=dev).view(1, h, 1)
    xx = torch.arange(w, device=dev).view(1, 1, w)
    off = yy * w + xx
    border = (yy == 0) | (yy == h - 1) | (xx == 0) | (xx == w - 1)
    cand = (v >= nb) & (v != gmin) & ~border
    prio = (v << _SHIFT) | off
    claim = torch.where(cand, prio, torch.zeros_like(prio))
    lo = v << _SHIFT
    hi = (v + tol + 1) << _SHIFT
    while True:
        before = claim
        for _ in range(16):
            best = torch.zeros_like(claim)
            for s in _neighbours(_pad(claim, 0), h, w):
                best = torch.maximum(best, torch.where(s < hi, s, torch.zeros_like(s)))
            best = torch.where(best >= lo, best, torch.zeros_like(best))
            claim = torch.maximum(claim, best)
        if torch.equal(claim, before):
            break
    has = claim > 0
    v0 = claim >> _SHIFT
    zbase = torch.arange(z, device=dev).view(z, 1, 1) * (h * w)
    label = zbase + (claim & ((1 << _SHIFT) - 1))  # the claim's origin pixel, flat
    dead = has & ((nb > v0) | (_nbmax(claim, 0) > claim) | border)
    killed = torch.zeros(z * h * w, dtype=torch.bool, device=dev)
    killed[label[dead]] = True
    keep = cand & (claim == prio) & ~killed.view(z, h, w)
    # each surviving region's pick among its pixels of value v0
    eq = has & (v == v0)
    lab = label[eq]
    ex = xx.expand(z, h, w)[eq].to(torch.float32)
    ey = yy.expand(z, h, w)[eq].to(torch.float32)
    n = z * h * w
    cnt = torch.zeros(n, device=dev).index_add_(0, lab, torch.ones_like(ex))
    cx = torch.zeros(n, device=dev).index_add_(0, lab, ex) / cnt.clamp(min=1.0)
    cy = torch.zeros(n, device=dev).index_add_(0, lab, ey) / cnt.clamp(min=1.0)
    d2 = (ex - cx[lab]) ** 2 + (ey - cy[lab]) ** 2
    dmin = torch.full((n,), float("inf"), device=dev).scatter_reduce_(0, lab, d2, "amin")
    near = d2 == dmin[lab]
    offs = (ey * w + ex).to(torch.int64)
    pick = torch.full((n,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, lab[near], offs[near], "amax")
    origins = (zbase + off).expand(z, h, w)[keep]
    chosen = pick[origins]
    ok = chosen >= 0
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[(origins - origins % (h * w) + chosen)[ok]] = True
    return mask.view(z, h, w)
