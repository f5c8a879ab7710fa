"""Clamped trilinear image sampling.

Port of pnr_tpu/ops/interp.py `trilinear` (parity target
`Tracker::interp`, pnr-vaa3d/tracker.cpp:2138-2215): coordinates are
clamped to [0, dim-1.001] before the floor, so both gather corners stay
in range and out-of-volume queries sample the nearest edge. The eight
corners are read with one flat gather each. A one-plane volume (l == 1)
ignores z and samples bilinearly, in JAX's order of operations.
`interpz` (Frangi::interpz) interpolates along z only.
"""

from __future__ import annotations

import torch


def trilinear(vol: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Sample a batch of volumes `vol` (N, Z, Y, X) at float coordinates
    of shape (N, ...): row n samples volume n. Returns float32."""
    n, l, h, w = vol.shape
    x, y, z = torch.broadcast_tensors(x, y, z)
    shape = x.shape
    x = x.reshape(n, -1)
    y = y.reshape(n, -1)
    z = z.reshape(n, -1)
    flat = vol.reshape(n, l * h * w).to(torch.float32)

    xc = torch.clamp(x, 0.0, w - 1.001)
    x1 = torch.floor(xc)
    xf = xc - x1
    yc = torch.clamp(y, 0.0, h - 1.001)
    y1 = torch.floor(yc)
    yf = yc - y1
    if l == 1:
        i0 = y1.long() * w + x1.long()
        r1a, r1b = torch.gather(flat, 1, i0), torch.gather(flat, 1, i0 + 1)
        r2a, r2b = torch.gather(flat, 1, i0 + w), torch.gather(flat, 1, i0 + w + 1)
        out = (1 - yf) * ((1 - xf) * r1a + xf * r1b) + yf * ((1 - xf) * r2a + xf * r2b)
        return out.reshape(shape)
    zc = torch.clamp(z, 0.0, l - 1.001)
    z1 = torch.floor(zc)
    zf = zc - z1
    i0 = (z1.long() * h + y1.long()) * w + x1.long()

    def g(off):
        return torch.gather(flat, 1, i0 + off)

    r11a, r11b = g(0), g(1)
    r21a, r21b = g(w), g(w + 1)
    r12a, r12b = g(h * w), g(h * w + 1)
    r22a, r22b = g(h * w + w), g(h * w + w + 1)
    plane1 = (1 - yf) * ((1 - xf) * r11a + xf * r11b) + yf * ((1 - xf) * r21a + xf * r21b)
    plane2 = (1 - yf) * ((1 - xf) * r12a + xf * r12b) + yf * ((1 - xf) * r22a + xf * r22b)
    out = (1 - zf) * plane1 + zf * plane2
    return out.reshape(shape)


def interpz(vol: torch.Tensor, x, y, z) -> torch.Tensor:
    """Interpolate a (Z, Y, X) volume along z only at integer (x, y)
    (Frangi::interpz, pnr-vaa3d/frangi.cpp:1201-1228); float32."""
    l = vol.shape[0]
    v = vol.to(torch.float32)
    dev = vol.device
    xi = torch.as_tensor(x, device=dev).to(torch.int64)
    yi = torch.as_tensor(y, device=dev).to(torch.int64)
    if l == 1:
        return v[0, yi, xi]
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    z1 = torch.clamp(z.to(torch.int32), 0, l - 2)
    zf = torch.clamp(z - z1, 0.0, 1.0)
    z1 = z1.to(torch.int64)
    i1 = v[z1, yi, xi]
    i2 = v[z1 + 1, yi, xi]
    return (1 - zf) * i1 + zf * i2
