"""Debug exporters: precomputed structures and traces as SWC / logs.

Parity targets (component 35, SURVEY.md §2): `Tracker::export_model /
export_off3 / export_track / export_trackcorr` (tracker.cpp:623-749),
`SeedExtractor::export_seeds/export_Suv/export_Suwv` (seed.cpp:493-554),
`export_directionality` (Advantra_plugin.cpp:1862-1883) and
`save_vector` (:701-712). These write SWC point clouds for visual
inspection — the reference's de-facto test oracle.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def save_vector(values: Sequence[float], path: str) -> None:
    """Comma-separated scalar log (Advantra_plugin.cpp:701-712)."""
    with open(path, "w") as f:
        f.write(",".join(f"{v:g}" for v in values) + "\n")


def export_points_swc(path: str, pts, ntype: int = 1, radius: float = 0.3) -> None:
    """Generic SWC point cloud: pts rows are (x, y, z[, radius])."""
    with open(path, "w") as f:
        for i, p in enumerate(pts, start=1):
            r = p[3] if len(p) > 3 else radius
            f.write(f"{i} {ntype} {p[0]:g} {p[1]:g} {p[2]:g} {r:g} -1\n")


def export_seeds_swc(
    path: str, pos, dirs=None, ntype: int = 7, arrow: float = 10.0, corr=None
) -> None:
    """Seeds (+ direction arrows) as SWC (seed.cpp:519-540 export_seeds).

    The reference writes each seed's ZNCC correlation in the radius
    column (`seeds[i].corr`, seed.cpp:529) — the per-seed signal its
    debug SWCs visualize as node size; pass `corr` to match (falls back
    to a fixed .3 marker radius when absent)."""
    pos = np.asarray(pos)
    lines = []
    cnt = 1
    for i in range(len(pos)):
        r = f"{float(np.asarray(corr)[i]):g}" if corr is not None else ".3"
        lines.append(f"{cnt} {ntype} {pos[i,0]:g} {pos[i,1]:g} {pos[i,2]:g} {r} -1")
        base = cnt
        cnt += 1
        if dirs is not None:
            d = np.asarray(dirs)[i]
            tip = pos[i] + arrow * d
            lines.append(f"{cnt} {ntype} {tip[0]:g} {tip[1]:g} {tip[2]:g} .1 {base}")
            cnt += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_offsets_swc(path: str, offset_groups, shift: float) -> None:
    """Offset clouds per group, x-shifted for visualization
    (export_off3/export_Suv/export_Suwv)."""
    lines = []
    cnt = 1
    for gi, offs in enumerate(offset_groups):
        for o in np.asarray(offs):
            lines.append(
                f"{cnt} {gi} {o[0] + gi * shift:g} {o[1]:g} {o[2] if len(o) > 2 else 0:g} .3 -1"
            )
            cnt += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_model_swc(path: str, templates, shift: float | None = None) -> None:
    """ZNCC template offsets + weights as SWC (tracker.cpp:639-652)."""
    if shift is None:
        shift = 2 * 3 * max(templates.sigmas)
    lines = []
    cnt = 1
    for si in range(len(templates.sigmas)):
        k = int(templates.cnt[si])
        offs = templates.offs[si, :k]
        wgt = templates.wgt[si, :k]
        for o, g in zip(offs, wgt):
            lines.append(f"{cnt} {si} {o[0] + si * shift:g} {o[1]:g} {o[2]:g} {g:g} -1")
            cnt += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_track_swc(path: str, pos, valid=None, ntype: int = 3) -> None:
    """One trace's estimate chain as SWC (tracker.cpp:722-734 export_track)."""
    pos = np.asarray(pos)
    if valid is not None:
        pos = pos[np.asarray(valid, bool)]
    lines = []
    for i in range(len(pos)):
        parent = -1 if i == 0 else i
        lines.append(
            f"{i + 1} {ntype} {pos[i,0]:g} {pos[i,1]:g} {pos[i,2]:g} .5 {parent}"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_track_corr(path: str, corr, valid=None, particle_corr=None) -> None:
    """Per-iteration correlations (tracker.cpp:736-749 export_trackcorr).

    The reference writes TWO lines per iteration: the centroid corr,
    then a comma-joined row of every particle's corr (xfilt[i][j].corr).
    Pass `particle_corr` (iters, npcles) to reproduce that structure;
    without it only the centroid lines are written."""
    corr = np.asarray(corr)
    keep = None
    if valid is not None:
        keep = np.asarray(valid, bool)
        corr = corr[keep]
    if particle_corr is not None:
        particle_corr = np.asarray(particle_corr)
        if keep is not None:
            particle_corr = particle_corr[keep]
    with open(path, "w") as f:
        for i, c in enumerate(corr):
            f.write(f"{c:g}\n")
            if particle_corr is not None:
                f.write(",".join(f"{p:g}" for p in particle_corr[i]) + "\n")


def export_directionality_swc(
    path: str, j8, vx_u8, vy_u8, vz_u8, threshold: int = 10, arrow: float = 10.0
) -> None:
    """Direction arrows at voxels with J8 > threshold
    (Advantra_plugin.cpp:1862-1883)."""
    j8 = np.asarray(j8)
    zz, yy, xx = np.nonzero(j8 > threshold)
    ux = (np.asarray(vx_u8)[zz, yy, xx] / 255.0) * 2 - 1
    uy = (np.asarray(vy_u8)[zz, yy, xx] / 255.0) * 2 - 1
    uz = (np.asarray(vz_u8)[zz, yy, xx] / 255.0) * 2 - 1
    lines = []
    cnt = 1
    for i in range(len(xx)):
        lines.append(f"{cnt} 17 {xx[i]} {yy[i]} {zz[i]} 0.1 -1")
        cnt += 1
        lines.append(
            f"{cnt} 17 {xx[i] + arrow * ux[i]:g} {yy[i] + arrow * uy[i]:g} "
            f"{zz[i] + arrow * uz[i]:g} 0.1 {cnt - 1}"
        )
        cnt += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def low_signal_diagnostic(result):
    """Flag the engine-said-no signature (VERDICT r4 item 7).

    At the SNR envelope edge the exact engine mirrors the reference
    (both trace noise fragments) while tube mode — whose
    locally-tube-like assumption rejects pure noise — emits an empty
    SWC with no signal that the ENGINE, not the specimen, said no.
    When seed extraction found maxima but nothing was committed, return
    a structured warning for --metrics / serve output (and the stderr
    line the pipelines print). Lives here (jax-free) so the host
    one-shot engine shares it."""
    if getattr(result, "n_raw_seeds", -1) <= 0:
        return None
    n0_nodes = max(len(result.n0) - 1, 0)
    if n0_nodes > 0:
        return None
    engine = getattr(result, "zncc_mode", "") or "?"
    hint = (
        "the tube likelihood rejected every candidate; retry with "
        "--zncc-mode exact (reference-parity behavior on low-SNR input)"
        if engine == "tube"
        else "every candidate fell below znccth; lower znccth or check "
        "acquisition SNR"
    )
    return {
        "engine": engine,
        "raw_maxima": int(result.n_raw_seeds),
        "selected_seeds": int(len(result.seeds_pos)),
        "trace_count": int(result.trace_count),
        "committed_nodes": n0_nodes,
        "message": (
            f"{result.n_raw_seeds} local maxima found but 0 nodes "
            f"committed under the '{engine}' engine — {hint}"
        ),
    }


def metrics_entry(path: str, result) -> dict:
    """One stack's machine-readable run record (timings + counts) —
    the JSON counterpart of the reference's clock() stage prints
    (Advantra_plugin.cpp:2430-2446, 2548-2575). `result` is a
    pipeline ReconstructionResult; its part spans (utils/spans.py), where
    it has them, go beside the stage timings as seconds `s` and count `n`
    by name."""
    entry = {
        "image": path,
        "timings_s": {k: round(float(v), 4) for k, v in result.timings.items()},
        "spans": {k: {"s": round(float(s), 6), "n": int(n)}
                  for k, (s, n) in getattr(result, "spans", {}).items()},
        "n_seeds": int(len(result.seeds_pos)),
        "trace_count": int(result.trace_count),
        "n0_nodes": max(len(result.n0) - 1, 0),
        "tree_nodes": max(len(result.tree) - 1, 0),
    }
    if getattr(result, "n_raw_seeds", -1) >= 0:
        entry["n_raw_seeds"] = int(result.n_raw_seeds)
        warn = low_signal_diagnostic(result)
        if warn is not None:
            entry["low_signal_warning"] = warn
    if getattr(result, "n_handoffs", -1) >= 0:
        entry["n_handoffs"] = int(result.n_handoffs)
        entry["n_requeued"] = int(result.n_requeued)
    return entry
