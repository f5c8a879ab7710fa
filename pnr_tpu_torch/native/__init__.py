"""ctypes bindings for the native host runtime (pnr_native.cpp).

Builds the shared library on demand with g++ into `pnr_tpu_torch/_build/`
under a name keyed by a hash of the source and flags (as ops/cuda.py
keys the CUDA library), so an edited source rebuilds. Every entry point
has a pure-NumPy fallback used when no compiler is available, so the
package never hard-fails: this is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pnr_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libpnr_native_{h.hexdigest()[:16]}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    out = library_path()
    if os.path.exists(out):
        return ctypes.CDLL(out)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)
        return ctypes.CDLL(out)
    except Exception:
        _build_failed = True
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _LOCK:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.max_finder_2d.restype = ctypes.c_int
                lib.max_finder_2d.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_double,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.c_int,
                ]
                lib.conn3d_regions.restype = ctypes.c_int
                lib.conn3d_regions.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int,
                ]
                lib.max_finder_stack.restype = ctypes.c_long
                lib.max_finder_stack.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_double,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int,
                ]
                lib.commit_steps_native.restype = ctypes.c_int
                lib.commit_steps_native.argtypes = [
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                ]
                lib.zncc_exact_queries.restype = None
                lib.zncc_exact_queries.argtypes = [
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_long,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int,
                ]
                lib.mean_shift_grid.restype = None
                lib.mean_shift_grid.argtypes = [
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_long,
                    ctypes.c_float,
                    ctypes.c_int,
                    ctypes.c_float,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int,
                ]
                lib.group_nodes.restype = ctypes.c_int
                lib.group_nodes.argtypes = [
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int,
                    ctypes.c_float,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                ]
            _lib = lib
    return _lib


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def have_native() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# max_finder_2d


def max_finder_2d(img: np.ndarray, tolerance: float) -> np.ndarray:
    """Single-point maxima of a 2-D uint8 slice; returns (N, 2) int (x, y)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    lib = get_lib()
    if lib is None:
        return _max_finder_2d_py(img, tolerance)
    max_out = h * w
    out = np.empty((max_out, 2), np.int32)
    n = lib.max_finder_2d(
        _u8p(img), w, h, float(tolerance),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
    )
    return out[:n].copy()


def commit_steps_native(
    npervol: np.ndarray,
    nidx: np.ndarray,
    smap,
    offs: np.ndarray,
    nodepervol: int,
    pos: np.ndarray,
    valid: np.ndarray,
    i0: int,
    upto: int,
    base_nid: int,
):
    """Raw binding for the native FCFS commit inner loop; returns
    (n_new, finished, ti_limit_or_None, stop_link_or_None) or None when
    the native library is unavailable (caller falls back to the Python
    loop). Mutates npervol/nidx in place.

    pos is float64 so the native rounding happens at the Python
    oracle's precision for any caller dtype; an estimate that rounds
    outside the volume raises IndexError (the oracle would too) instead
    of corrupting the maps."""
    lib = get_lib()
    if lib is None:
        return None
    l, h, w = npervol.shape
    pos = np.ascontiguousarray(pos, np.float64)
    valid = np.ascontiguousarray(valid, np.uint8)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (N, 3), got {pos.shape}")
    if not (0 <= i0 <= upto <= len(pos)) or upto > len(valid):
        raise ValueError(
            f"commit range [{i0}, {upto}) exceeds pos/valid length "
            f"{len(pos)}/{len(valid)}"
        )
    result = np.empty(4, np.int32)
    smap_p = (
        _i32p(smap)
        if smap is not None
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    )
    n_new = lib.commit_steps_native(
        _i32p(npervol), _i32p(nidx), smap_p, w, h, l,
        _i32p(offs), len(offs), int(nodepervol),
        _f64p(pos), _u8p(valid), int(i0), int(upto), int(base_nid),
        result.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n_new < 0:
        raise IndexError(
            f"commit_steps_native: estimate {int(result[1])} rounds "
            f"outside the ({l}, {h}, {w}) volume"
        )
    finished = bool(result[0])
    ti_limit = None if result[1] == -2 else int(result[1])
    stop_link = (int(result[2]), int(result[3])) if result[2] >= 0 else None
    return n_new, finished, ti_limit, stop_link


def zncc_exact_queries(vol_f32, templates, pos, dirs, n_threads: int = 0):
    """Exact znccBBB correlation for (N, 3) queries via the native
    kernel; returns (corr, sig) or None without the native library.
    `templates` is an ops.zncc_model.ZnccTemplates."""
    lib = get_lib()
    if lib is None:
        return None
    vol_f32 = np.ascontiguousarray(vol_f32, np.float32)
    l, h, w = vol_f32.shape
    pos = np.ascontiguousarray(pos, np.float32)
    dirs = np.ascontiguousarray(dirs, np.float32)
    n = len(pos)
    out_corr = np.empty(n, np.float32)
    out_sig = np.empty(n, np.float32)
    t = templates
    offs = np.ascontiguousarray(t.offs, np.float32)
    wgt = np.ascontiguousarray(t.wgt, np.float32)
    msk = np.ascontiguousarray(t.mask, np.float32)
    cnt = np.ascontiguousarray(t.cnt, np.float32)
    avg = np.ascontiguousarray(t.avg, np.float32)
    corrc = np.ascontiguousarray(t.corrc, np.float32)
    sig = np.ascontiguousarray(np.asarray(t.sigmas), np.float32)
    if n_threads == 0:
        n_threads = int(os.environ.get("PNR_TPU_ZNCC_THREADS", "0"))
    lib.zncc_exact_queries(
        _f32p(vol_f32), w, h, l,
        _f32p(offs), _f32p(wgt), _f32p(msk), _f32p(cnt), _f32p(avg),
        _f32p(corrc), _f32p(sig), len(t.sigmas), int(t.kmax),
        int(bool(t.is2d)), _f32p(pos), _f32p(dirs), n,
        _f32p(out_corr), _f32p(out_sig), int(n_threads),
    )
    return out_corr, out_sig


def mean_shift_grid(p4: np.ndarray, sig2rad: float, max_iter: int,
                    eps2: float, n_threads: int = 0):
    """Grid-binned non-blurring mean shift over (N, 4) float32 rows
    (x, y, z, sig); returns the converged (N, 4) or None without the
    native library. O(N * local density); double-precision interior
    (reference-oracle numerics — no coordinate-magnitude cancellation).
    """
    lib = get_lib()
    if lib is None:
        return None
    p4 = np.ascontiguousarray(p4, np.float32)
    out = np.empty_like(p4)
    if n_threads == 0:
        n_threads = int(os.environ.get("PNR_TPU_REFINE_THREADS", "0"))
    lib.mean_shift_grid(
        _f32p(p4), len(p4), float(sig2rad), int(max_iter), float(eps2),
        _f32p(out), int(n_threads),
    )
    return out


def max_finder_stack(
    vol: np.ndarray, tolerance: float, n_threads: int = 0
) -> Optional[np.ndarray]:
    """Per-slice tolerance flood over a (Z, H, W) uint8 stack -> bool
    mask, sliced round-robin over a native std::thread pool (the flood
    is strictly per z-slice — seed.cpp:574 — so slices are
    embarrassingly parallel and results are deterministic at any thread
    count). n_threads=0 uses hardware concurrency; honours the
    PNR_TPU_FLOOD_THREADS env override. Returns None without the
    native library (callers fall back to the per-slice loop)."""
    lib = get_lib()
    if lib is None:
        return None
    vol = np.ascontiguousarray(vol, dtype=np.uint8)
    l, h, w = vol.shape
    if n_threads == 0:
        n_threads = int(os.environ.get("PNR_TPU_FLOOD_THREADS", "0"))
    mask = np.empty((l, h, w), np.uint8)
    lib.max_finder_stack(
        _u8p(vol), w, h, l, float(tolerance), _u8p(mask), int(n_threads)
    )
    return mask.astype(bool)


def _max_finder_2d_py(img: np.ndarray, tolerance: float) -> np.ndarray:
    """Pure-Python reference of the same sequential algorithm (slow; fallback/oracle)."""
    h, w = img.shape
    if w < 3 or h < 3:
        return np.empty((0, 2), np.int32)
    gmin = int(img.min())
    v = img.astype(np.int32)
    # interior local maxima (no strictly greater 8-neighbour)
    nb = np.full((h, w), -1, np.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            sl = v[max(0, dy) : h + min(0, dy), max(0, dx) : w + min(0, dx)]
            tgt = nb[max(0, -dy) : h + min(0, -dy), max(0, -dx) : w + min(0, -dx)]
            np.maximum(tgt, sl, out=tgt)
    is_max = (v >= nb) & (v != gmin)
    is_max[0, :] = is_max[-1, :] = False
    is_max[:, 0] = is_max[:, -1] = False
    ys, xs = np.nonzero(is_max)
    offs = ys * w + xs
    order = np.argsort(v[ys, xs].astype(np.int64) * (h * w) + offs)[::-1]

    PROCESSED, LISTED, EQUAL = 4, 2, 8
    types = np.zeros(h * w, np.uint8)
    out = []
    flat = img.reshape(-1)
    for oi in order:
        off0 = int(offs[oi])
        if types[off0] & PROCESSED:
            continue
        v0 = float(flat[off0])
        plist = [off0]
        types[off0] |= LISTED | EQUAL
        max_possible = True
        x_eq, y_eq, n_eq = off0 % w, off0 // w, 1
        li = 0
        while li < len(plist) and max_possible:
            off = plist[li]
            px, py = off % w, off // w
            for dx, dy in ((0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1)):
                qx, qy = px + dx, py + dy
                if qx < 0 or qx >= w or qy < 0 or qy >= h:
                    continue
                qoff = qy * w + qx
                if types[qoff] & LISTED:
                    continue
                if types[qoff] & PROCESSED:
                    max_possible = False
                    break
                v2 = float(flat[qoff])
                if v2 > v0:
                    max_possible = False
                    break
                if v2 >= v0 - tolerance:
                    plist.append(qoff)
                    types[qoff] |= LISTED
                    if qx == 0 or qx == w - 1 or qy == 0 or qy == h - 1:
                        max_possible = False
                        break
                    if v2 == v0:
                        types[qoff] |= EQUAL
                        x_eq += qx
                        y_eq += qy
                        n_eq += 1
            li += 1
        x_eq /= n_eq
        y_eq /= n_eq
        best_d2, best_off = 1e20, off0
        for off in plist:
            keep_eq = types[off] & EQUAL
            types[off] &= ~np.uint8(LISTED | (0 if max_possible else EQUAL))
            types[off] |= PROCESSED
            if max_possible and keep_eq:
                px, py = off % w, off // w
                d2 = (x_eq - px) ** 2 + (y_eq - py) ** 2
                if d2 < best_d2:
                    best_d2, best_off = d2, off
        if max_possible:
            out.append((best_off % w, best_off // w))
    return np.asarray(out, np.int32).reshape(-1, 2)


# ---------------------------------------------------------------------------
# conn3d


def conn3d(
    img: np.ndarray,
    value_over: int = 0,
    min_size: int = 1,
    diagonal: bool = True,
    max_regions: int = 1 << 30,
) -> Tuple[np.ndarray, np.ndarray]:
    """Same-value 3-D connected components (toolbox.cpp:245 `conn3d`).

    img: (Z, Y, X) uint8. Returns (labels int32 (Z,Y,X), regions (N,4)
    float32 rows of centroid x, y, z and mean radius).
    """
    img = np.ascontiguousarray(img, dtype=np.uint8)
    d, h, w = img.shape
    lib = get_lib()
    if lib is None:
        return _conn3d_py(img, value_over, min_size, diagonal)
    labels = np.zeros(img.shape, np.int32)
    cap = min(max_regions, img.size + 1)
    regions = np.zeros((cap, 4), np.float32)
    n = lib.conn3d_regions(
        _u8p(img), w, h, d, int(value_over), int(min_size), int(bool(diagonal)),
        _i32p(labels), _f32p(regions), cap,
    )
    return labels, regions[:n].copy()


def _conn3d_py(img, value_over, min_size, diagonal):
    import scipy.ndimage as ndi

    d, h, w = img.shape
    labels = np.zeros(img.shape, np.int32)
    regions = []
    structure = np.ones((3, 3, 3), bool) if diagonal else ndi.generate_binary_structure(3, 1)
    next_label = 0
    for val in np.unique(img):
        if val <= value_over:
            continue
        lab, nlab = ndi.label(img == val, structure=structure)
        for k in range(1, nlab + 1):
            mask = lab == k
            if mask.sum() < min_size:
                continue
            next_label += 1
            labels[mask] = next_label
            zz, yy, xx = np.nonzero(mask)
            xm, ym, zm = xx.mean(), yy.mean(), zz.mean()
            rm = np.sqrt((xx - xm) ** 2 + (yy - ym) ** 2 + (zz - zm) ** 2).mean()
            regions.append((xm, ym, zm, rm))
    return labels, np.asarray(regions, np.float32).reshape(-1, 4)


# ---------------------------------------------------------------------------
# group_nodes


def group_nodes(x, y, z, sig, corr, is_soma, rad: float):
    """Greedy sphere grouping (Advantra_plugin.cpp:1566 `group1`).

    Returns (group_of int32 (n,), groups float32 (G, 5) rows x,y,z,sig,corr).
    Soma nodes become singleton groups first.
    """
    n = len(x)
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    z = np.ascontiguousarray(z, np.float32)
    sig = np.ascontiguousarray(sig, np.float32)
    corr = np.ascontiguousarray(corr, np.float32)
    is_soma = np.ascontiguousarray(is_soma, np.uint8)
    lib = get_lib()
    if lib is None:
        return _group_nodes_py(x, y, z, sig, corr, is_soma, rad)
    group_of = np.empty(n, np.int32)
    gx = np.empty(n, np.float32)
    gy = np.empty(n, np.float32)
    gz = np.empty(n, np.float32)
    gsig = np.empty(n, np.float32)
    gcorr = np.empty(n, np.float32)
    ng = lib.group_nodes(
        _f32p(x), _f32p(y), _f32p(z), _f32p(sig), _f32p(corr), _u8p(is_soma),
        n, float(rad), _i32p(group_of),
        _f32p(gx), _f32p(gy), _f32p(gz), _f32p(gsig), _f32p(gcorr),
    )
    groups = np.stack([gx[:ng], gy[:ng], gz[:ng], gsig[:ng], gcorr[:ng]], axis=-1)
    return group_of, groups


def _group_nodes_py(x, y, z, sig, corr, is_soma, rad):
    n = len(x)
    group_of = np.full(n, -1, np.int32)
    groups = []
    for i in range(n):
        if is_soma[i]:
            group_of[i] = len(groups)
            groups.append([x[i], y[i], z[i], sig[i], corr[i]])
    order = np.argsort(-corr, kind="stable")
    r2 = rad * rad
    for ci in order:
        if group_of[ci] != -1:
            continue
        g = len(groups)
        group_of[ci] = g
        acc = [x[ci], y[ci], z[ci], sig[ci], corr[ci]]
        cnt = 1.0
        d2 = (x - x[ci]) ** 2 + (y - y[ci]) ** 2 + (z - z[ci]) ** 2
        for j in np.nonzero((d2 <= r2) & (group_of == -1))[0]:
            if j == ci:
                continue
            group_of[j] = g
            cnt += 1.0
            a, b = (cnt - 1.0) / cnt, 1.0 / cnt
            acc = [
                a * acc[0] + b * x[j],
                a * acc[1] + b * y[j],
                a * acc[2] + b * z[j],
                a * acc[3] + b * sig[j],
                a * acc[4] + b * corr[j],
            ]
        groups.append(acc)
    return group_of, np.asarray(groups, np.float32).reshape(-1, 5)


def conn2d(img: np.ndarray, background: int = 0) -> Tuple[np.ndarray, int]:
    """2-D connected components with 8-connectivity over same-valued pixels.

    Functional equivalent of the reference's (dead-code) templated
    union-find `ConnectedComponents` (connected.h:13-188). Returns
    (labels int32 (H, W) with 1-based ids, number of components).
    """
    import scipy.ndimage as ndi

    img = np.asarray(img)
    labels = np.zeros(img.shape, np.int32)
    structure = np.ones((3, 3), bool)
    next_label = 0
    for val in np.unique(img):
        if val == background:
            continue
        lab, nlab = ndi.label(img == val, structure=structure)
        mask = lab > 0
        labels[mask] = lab[mask] + next_label
        next_label += nlab
    return labels, next_label
