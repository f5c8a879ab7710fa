"""SWC neuron morphology read/write.

Parity target: `save_nodelist` (pnr-vaa3d/Advantra_plugin.cpp:480-523):
one SWC row per (node, neighbour-link) — node ids duplicate per link so
bidirectional graphs round-trip — with radius = sig2r * sigma, and the
full parameter-provenance comment embedded in the header
(the COMMENT string, Advantra_plugin.cpp:2277-2306).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pnr_tpu_torch.graph.nodes import NodeList


def save_nodelist(
    nodes: NodeList,
    path: str,
    ntype: int = -1,
    sig2r: float = 1.0,
    name: str = "",
    comment: str = "",
) -> None:
    lines = []
    if name:
        lines.append(f"#name {name}")
    if comment:
        for c in comment.split("\n"):
            lines.append(f"#{c}" if not c.startswith("#") else c)
    lines.append("##n,type,x,y,z,radius,parent")
    for i in range(1, len(nodes)):
        t = nodes.type[i] if ntype == -1 else ntype
        r = sig2r * nodes.sig[i]
        base = f"{i} {t} {nodes.x[i]:g} {nodes.y[i]:g} {nodes.z[i]:g} {r:g}"
        if not nodes.nbr[i]:
            lines.append(f"{base} -1")
        else:
            for p in nodes.nbr[i]:
                lines.append(f"{base} {p}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_swc(path: str) -> np.ndarray:
    """Read SWC rows as an (N, 7) float array (n, type, x, y, z, r, parent)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) >= 7:
                rows.append([float(v) for v in parts[:7]])
    return np.asarray(rows, np.float64).reshape(-1, 7)


def swc_to_nodelist(swc: np.ndarray) -> NodeList:
    """Build a NodeList from SWC rows (ids may repeat per link)."""
    nodes = NodeList()
    idmap = {}
    for row in swc:
        nid = int(row[0])
        if nid not in idmap:
            idmap[nid] = nodes.add(row[2], row[3], row[4], sig=row[5], ntype=int(row[1]))
    for row in swc:
        nid, parent = int(row[0]), int(row[6])
        if parent >= 0 and parent in idmap and nid in idmap:
            i, j = idmap[nid], idmap[parent]
            if j not in nodes.nbr[i]:
                nodes.nbr[i].append(j)
    return nodes
