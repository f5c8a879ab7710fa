"""Peaks, bounds and the work the kernels' rooflines count, frozen for the benchmark.

Copied from chip_smoke.py (`PEAK_BYTES_S`, `PEAK_F32_FLOP_S`, `EIG_FLOPS`,
`K2_SAMPLE_FLOPS`, `HAT_ROW_FLOPS`, `ZNCC_FLOPS`, `bound`, `frangi_flops`)
as they stood when the benchmark was defined, so that a later change to
the program or its smoke test cannot move a roofline. The peaks are NVIDIA's
published H100 SXM figures (dense, without sparsity, at the 700 W limit).
"""

from __future__ import annotations

import math

#: device memory bytes/s and float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
#: FLOP-equivalents per voxel and sigma of the eigensolve, vesselness and
#: merge (~150 arithmetic FLOPs plus acos, two cos, five sqrt, three exp
#: and a dozen divisions at ~8 each)
EIG_FLOPS = 250
#: FLOPs of one K2 template sample: its patch coordinate (8 fused
#: multiply-adds, clamps, floors), the trilinear sample (7 lerps) and the
#: three sums
K2_SAMPLE_FLOPS = 60
#: FLOPs of one tube_corr line sample: its point and window coordinates,
#: six hat weights, four z-y weight products, 24 fused multiply-adds, the
#: x contraction of three channels, the mask and the sum over the line
HAT_ROW_FLOPS = 112
#: FLOPs of one tube ZNCC per query and sigma from its three sums
ZNCC_FLOPS = 30


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory rate and the FLOPs over the float32 rate."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S)


def taps(sigma: float) -> int:
    """Taps of a sampled Gaussian of half-width ceil(3 sigma)."""
    return 2 * int(math.ceil(3.0 * float(sigma))) + 1


def frangi_flops(n: int, sigmas, zdist: float) -> float:
    """FLOPs of the multi-scale Frangi on n voxels: 2 per Gaussian tap (x,
    y and z passes), 2 per difference pass (9 per sigma), EIG_FLOPS."""
    per = sum(2 * (2 * taps(s) + taps(float(s) / zdist)) + 9 * 2 + EIG_FLOPS for s in sigmas)
    return float(n) * per


def frangi_bytes(n: int) -> float:
    """K1's bytes: the uint8 stack in once; J (float32) and three uint8
    direction volumes out once."""
    return float(n) * (1 + 4 + 3)


def _grid_len(half: int, pitch: float) -> int:
    return int(math.floor((2.0 * half) / pitch + 1e-6)) + 1


def template_samples(sigmas) -> int:
    """Samples of one exact query over all sigmas (the template lattice)."""
    total = 0
    for s in sigmas:
        pitch = max(1.0, 3.0 * float(s) / 12.0)
        nv = _grid_len(int(round(float(s))), pitch)
        nu = _grid_len(int(round(3.0 * float(s))), pitch)
        total += nv * nu * nu
    return total


def line_samples(sigmas) -> int:
    """Line samples of one tube query over all sigmas."""
    return sum(_grid_len(int(round(float(s))), max(1.0, 3.0 * float(s) / 12.0)) for s in sigmas)
