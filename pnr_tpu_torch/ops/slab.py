"""Where a likelihood field lies in a larger volume.

A shard of the sharded pipeline (pnr_tpu_torch/parallel) builds its field
from a slab of the volume: the planes (or, on a one-plane stack, the rows)
[w0, w0 + S). `SlabFrame` tells the engines and the tracer so: positions
stay in the whole volume's coordinates, samples clamp to the whole
volume's bounds, and windows are placed as in the whole volume and then
read from the slab, so a trace that stays inside its slab computes
bitwise what it computes on the whole volume.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch


@functools.lru_cache(maxsize=256)
def _int3(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A small int32 tensor on `device`, made once (the tracer asks for the
    same few every iteration)."""
    return torch.tensor(values, dtype=torch.int32, device=device)


class SlabFrame(NamedTuple):
    """The field holds the volume's elements from `origin` (zyx) on; `dims`
    are the whole volume's (Z, Y, X)."""

    origin: Tuple[int, int, int]
    dims: Tuple[int, int, int]

    def into(self, corner: torch.Tensor, pdims, field_dims) -> torch.Tensor:
        """Window origins `corner` (..., 3) int32 zyx in the volume, shifted
        into the field (origin + clamp(corner - origin, 0, field - p)):
        unchanged for a window that lies inside the field. `pdims` the (pz, py,
        px) window dims, or a (G, 3) int32 tensor of them; `field_dims` the field's (Z, Y, X)."""
        o = _int3(tuple(self.origin), corner.device)
        if isinstance(pdims, torch.Tensor):
            hi = _int3(tuple(int(d) for d in field_dims), corner.device) - pdims
        else:
            hi = _int3(tuple(int(f) - int(p) for f, p in zip(field_dims, pdims)), corner.device)
        return torch.minimum(torch.clamp(corner - o, min=0), hi) + o

    def local(self, corner: torch.Tensor) -> torch.Tensor:
        """Window origins in the field's own coordinates."""
        return (corner - _int3(tuple(self.origin), corner.device)).contiguous()

    def in_field(self, cpos: torch.Tensor, field_dims, rounded) -> torch.Tensor:
        """(T,) bool: the centroids `cpos` (T, 3) xyz, rounded by `rounded`,
        lie in the field's part of the volume."""
        ok = None
        for axis, (o, n) in enumerate(zip(reversed(self.origin), reversed(tuple(field_dims)))):
            r = rounded(cpos[:, axis])
            a = (r >= o) & (r < o + n)
            ok = a if ok is None else ok & a
        return ok
