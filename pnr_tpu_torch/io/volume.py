"""Volume I/O: multi-page TIFF, Vaa3D .v3draw, and .npy stacks.

The reference delegates to Vaa3D's `simple_loadimage_wrapper`
(Advantra_plugin.cpp:2241); this framework loads on host into a
(Z, Y, X) uint8 numpy array. TIFF via PIL (multi-frame); .v3draw via a
reader for Vaa3D's raw format ("raw_image_stack_by_hpeng" header).
"""

from __future__ import annotations

import os
import struct

import numpy as np

_V3D_MAGIC = b"raw_image_stack_by_hpeng"
_PBD_MAGIC = b"v3d_volume_pkbitdf_encod"

#: every extension `load_volume` accepts (the watch-directory server
#: keys its file filter off this — keep in sync with the dispatch below)
LOADABLE_EXTS = (".tif", ".tiff", ".v3draw", ".raw", ".v3dpbd", ".npy")


def load_volume(path: str) -> np.ndarray:
    """Load a volume as (Z, Y, X) uint8."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        return _load_tif(path)
    if ext in (".v3draw", ".raw"):
        return _load_v3draw(path)
    if ext == ".v3dpbd":
        return _load_v3dpbd(path)
    if ext == ".npy":
        return as_u8_volume(np.load(path))
    raise ValueError(f"unsupported volume format: {path}")


def probe_volume_shape(path: str) -> tuple:
    """(Z, Y, X) of a stack from its header alone — no voxel reads.

    Feeds `parallel.plan_sharded` (mesh sizing for stacks that may not
    fit host RAM) and the CLI `--plan` mode.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        # a memory map reads the header and no voxel (numpy's private
        # header reader is gone from numpy 2.x)
        shape = np.load(path, mmap_mode="r").shape
        if len(shape) == 2:
            shape = (1,) + tuple(shape)
        if len(shape) != 3:
            raise ValueError(f"expected a (Z, Y, X) stack, got {shape}")
        return tuple(int(s) for s in shape)
    if ext in (".v3draw", ".raw", ".v3dpbd"):
        magic = _V3D_MAGIC if ext != ".v3dpbd" else _PBD_MAGIC
        with open(path, "rb") as f:
            if f.read(len(magic)) != magic:
                raise ValueError(f"bad magic in {path}")
            fmt = "<" if f.read(1) == b"L" else ">"
            f.read(2)  # datatype
            w, h, l, _c = struct.unpack(fmt + "4i", f.read(16))
        return (int(l), int(h), int(w))
    if ext in (".tif", ".tiff"):
        from PIL import Image

        with Image.open(path) as img:
            w, h = img.size
            return (int(getattr(img, "n_frames", 1)), int(h), int(w))
    raise ValueError(f"unsupported volume format: {path}")


def load_volume_mmap(path: str) -> np.ndarray:
    """Memory-map a uint8 volume as a read-only (Z, Y, X) view.

    The multi-host loading contract (`parallel.shard_volume_global`)
    only requires `vol[idx]` — with a mapped view each host touches
    ONLY the pages of its own Z slabs, so a >2048^3 stack never needs
    to fit host RAM. Supported: `.npy` (uint8, C-order) and `.v3draw`
    single-channel uint8 (the data section is raw voxels at a fixed
    header offset). Compressed/encoded containers (.tif, .v3dpbd)
    cannot be mapped — load those with `load_volume` or convert once:
    `save_volume(out + '.v3draw', load_volume(inp))`.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        vol = np.load(path, mmap_mode="r")
        if vol.dtype != np.uint8:
            raise ValueError(
                f"mmap load requires a uint8 .npy (got {vol.dtype}); "
                "normalization would materialize the full volume — use "
                "load_volume or re-save as uint8"
            )
        if vol.ndim == 2:
            vol = vol[None]
        if vol.ndim != 3:
            raise ValueError(f"expected a (Z, Y, X) stack, got {vol.shape}")
        return vol
    if ext in (".v3draw", ".raw"):
        with open(path, "rb") as f:
            magic = f.read(len(_V3D_MAGIC))
            if magic != _V3D_MAGIC:
                raise ValueError(f"not a v3draw file: {path}")
            fmt = "<" if f.read(1) == b"L" else ">"
            (dcode,) = struct.unpack(fmt + "h", f.read(2))
            w, h, l, c = struct.unpack(fmt + "4i", f.read(16))
            offset = f.tell()
        if dcode != 1:
            raise ValueError(
                f"mmap load requires 8-bit v3draw (datatype {dcode}); "
                "use load_volume for 16-bit/float stacks"
            )
        if c != 1:
            raise ValueError(
                f"mmap load requires single-channel v3draw (got {c} "
                "channels; channel-major layout would need a strided view "
                "of remote pages) — use load_volume"
            )
        return np.memmap(path, np.uint8, mode="r", offset=offset, shape=(l, h, w))
    raise ValueError(
        f"cannot memory-map {ext or path}: only uint8 .npy and "
        "single-channel 8-bit .v3draw have a flat voxel section"
    )


def save_volume(path: str, vol: np.ndarray) -> None:
    """Save a (Z, Y, X) uint8 volume (TIFF multipage, v3draw, or npy)."""
    ext = os.path.splitext(path)[1].lower()
    vol = np.ascontiguousarray(vol, np.uint8)
    if ext in (".tif", ".tiff"):
        from PIL import Image

        frames = [Image.fromarray(s) for s in vol]
        frames[0].save(path, save_all=True, append_images=frames[1:])
    elif ext in (".v3draw", ".raw"):
        _save_v3draw(path, vol)
    elif ext == ".v3dpbd":
        _save_v3dpbd(path, vol)
    elif ext == ".npy":
        np.save(path, vol)
    else:
        raise ValueError(f"unsupported volume format: {path}")


def as_u8_volume(vol: np.ndarray) -> np.ndarray:
    """Coerce an array to a contiguous (Z, Y, X) uint8 volume.

    uint8 passes through untouched; wider dtypes are min-max normalized
    to [0, 255] (a plain cast would wrap around — the reference plugin
    only ever sees V3D uint8 buffers, but a framework-level API must
    accept what users hand it deterministically). 2-D arrays gain a
    singleton leading Z axis (the reference's P==1 convention)."""
    vol = np.asarray(vol)
    if vol.ndim == 2:
        vol = vol[None]
    return np.ascontiguousarray(_to_u8(vol))


def _to_u8(vol: np.ndarray) -> np.ndarray:
    if vol.dtype == np.uint8:
        return vol
    v = vol.astype(np.float64)
    vmin, vmax = v.min(), v.max()
    if np.isnan(vmin) or np.isnan(vmax):
        # one NaN voxel would otherwise poison the whole normalization
        # (NaN min/max -> all-NaN -> undefined uint8 cast); fail loud
        raise ValueError("volume contains NaN values")
    if np.isinf(vmin) or np.isinf(vmax):
        raise ValueError("volume contains infinite values")
    if vmax <= vmin:
        return np.zeros(vol.shape, np.uint8)
    return np.round((v - vmin) / (vmax - vmin) * 255.0).astype(np.uint8)


def _load_tif(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    frames = []
    i = 0
    while True:
        try:
            img.seek(i)
        except EOFError:
            break
        frames.append(np.asarray(img))
        i += 1
    vol = np.stack(frames)
    if vol.ndim == 4:  # RGB(A) -> first channel
        vol = vol[..., 0]
    return _to_u8(vol)


def _load_v3draw(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(len(_V3D_MAGIC))
        if magic != _V3D_MAGIC:
            raise ValueError(f"not a v3draw file: {path}")
        endian = f.read(1)
        fmt = "<" if endian == b"L" else ">"
        (dcode,) = struct.unpack(fmt + "h", f.read(2))
        dims = struct.unpack(fmt + "4i", f.read(16))
        w, h, l, c = dims
        n = w * h * l * c
        if dcode == 1:
            data = np.frombuffer(f.read(n), np.uint8)
        elif dcode == 2:
            dt = np.dtype(np.uint16).newbyteorder(fmt)
            data = np.frombuffer(f.read(2 * n), dt)
        elif dcode == 4:
            dt = np.dtype(np.float32).newbyteorder(fmt)
            data = np.frombuffer(f.read(4 * n), dt)
        else:
            raise ValueError(f"v3draw datatype {dcode} unsupported")
    vol = data.reshape(c, l, h, w)[0]  # first channel, (Z, Y, X)
    return _to_u8(vol)


def _save_v3draw(path: str, vol: np.ndarray) -> None:
    l, h, w = vol.shape
    with open(path, "wb") as f:
        f.write(_V3D_MAGIC)
        f.write(b"L")
        f.write(struct.pack("<h", 1))
        f.write(struct.pack("<4i", w, h, l, 1))
        f.write(vol.tobytes())


def _load_v3dpbd(path: str) -> np.ndarray:
    """Vaa3D PBD-compressed raw (the format many gold166 stacks ship in).

    Header layout matches .v3draw (ImageLoaderBasic::loadRaw2StackPBD);
    the remainder of the file is the PBD8 stream (see pnr_tpu.io.pbd).
    """
    from pnr_tpu_torch.io.pbd import decompress_pbd8

    with open(path, "rb") as f:
        magic = f.read(len(_PBD_MAGIC))
        if magic != _PBD_MAGIC:
            raise ValueError(f"not a v3dpbd file: {path}")
        endian = f.read(1)
        fmt = "<" if endian == b"L" else ">"
        (dcode,) = struct.unpack(fmt + "h", f.read(2))
        w, h, l, c = struct.unpack(fmt + "4i", f.read(16))
        if dcode != 1:
            raise ValueError(
                f"v3dpbd datatype {dcode} unsupported (only 8-bit PBD is "
                "implemented; convert 16-bit stacks to .v3draw)"
            )
        payload = np.frombuffer(f.read(), np.uint8)
    data = decompress_pbd8(payload, w * h * l * c)
    return _to_u8(data.reshape(c, l, h, w)[0])


def _save_v3dpbd(path: str, vol: np.ndarray) -> None:
    from pnr_tpu_torch.io.pbd import compress_pbd8

    l, h, w = vol.shape
    with open(path, "wb") as f:
        f.write(_PBD_MAGIC)
        f.write(b"L")
        f.write(struct.pack("<h", 1))
        f.write(struct.pack("<4i", w, h, l, 1))
        f.write(compress_pbd8(vol).tobytes())
