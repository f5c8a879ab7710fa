"""Device-memory planning for sharded reconstructions on CUDA cards.

Port of pnr_tpu/parallel/plan.py. `plan_sharded` computes the per-shard
device-memory peak of each stage of `reconstruction_func_sharded` from the
buffers the port allocates, and `min_devices` inverts it: the smallest
1-D mesh on which a (volume, config) fits a card. The structure is JAX's
(a peak-resident model by stage, with the stage halos); the constants are
the port's, measured on an H100 by chip_smoke.py and kept in
pipeline/reconstruct.py, not the TPU's:

- the filter: the route `frangi3d_sharded` takes on the halo slab
  (`sharded.slab_filter_route`, the lower of the two peaks): the
  monolithic unfused filter's bytes per voxel
  (`UNFUSED_PEAK_BYTES_PER_VOXEL`, the slab included), or the tiled
  engine's outputs and stage (`FUSED_PEAK_BYTES_PER_VOXEL`) plus one tile
  of `TILE_VOX_BUDGET` voxels at the unfused peak; a one-plane stack
  `frangi2d`'s bytes per pixel (`FRANGI2D_PEAK_BYTES_PER_PIXEL`, or the
  tiled route's above `FRANGI2D_TILED_PIXELS`);
- the likelihood field on the trace-halo slab: the uint8 slab itself in
  exact mode; in tube mode 12 bytes per voxel and sigma in float32 (6 in
  bfloat16, as `BatchedTracker.prepare_field` routes it) plus the build's
  `TUBE_BUILD_PEAK_BYTES_PER_VOXEL`;
- the halos: `frangi_halo` / `frangi2d_halo` and `required_trace_halo`,
  each slab clipped to the volume (the port's slabs are aligned windows,
  parallel/halo.py);
- the card's memory: `torch.cuda.get_device_properties`, or the
  `mem_bytes` the caller passes (the CPU tests do).

`usable_fraction` (0.85 of the card) leaves room for the allocator's
fragmentation and the CUDA context; `fits` errs conservative.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from pnr_tpu_torch.config import PNRConfig

#: the uint8 J8 and three uint8 direction volumes of a shard's own planes
_SEED_MAPS_B_PER_VOX = 4
#: J (float32) and three uint8 directions cropped from a shard's halo slab
_CROP_B_PER_VOX = 7
#: per-lane particle state (positions, directions, weights, indices and
#: the tracer's per-iteration temporaries), as in JAX's model
_TRACE_STATE_B_PER_LANE_PARTICLE = 64


def card_memory_bytes(device="cuda") -> int:
    """The device memory of a card (raises without one)."""
    import torch

    from pnr_tpu_torch.utils.runtime import require_cuda

    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError(f"a plan is for a card; {dev} has no device memory to plan")
    return int(torch.cuda.get_device_properties(dev).total_memory)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Per-shard memory plan for one (volume, config, mesh) choice."""

    shape: Tuple[int, int, int]
    n_devices: int
    stages: Dict[str, int]  # stage name -> peak bytes per shard
    mem_bytes: int
    usable_fraction: float

    @property
    def peak_bytes(self) -> int:
        return max(self.stages.values())

    @property
    def peak_stage(self) -> str:
        return max(self.stages, key=self.stages.get)

    @property
    def fits(self) -> bool:
        return self.peak_bytes <= self.mem_bytes * self.usable_fraction

    def summary(self) -> str:
        gib = 1 << 30
        lines = [
            f"volume {self.shape} over {self.n_devices} card(s), device memory "
            f"{self.mem_bytes / gib:.1f} GiB (usable {self.usable_fraction:.0%}):"
        ]
        for name, b in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<28s} {b / gib:7.2f} GiB/shard")
        verdict = "fits" if self.fits else "DOES NOT FIT"
        lines.append(
            f"  peak = {self.peak_stage} -> {self.peak_bytes / gib:.2f} GiB/shard: {verdict}"
        )
        return "\n".join(lines)


def _shard_extent(axis_len: int, n: int) -> int:
    # reconstruction_func_sharded replicate-pads the sharded axis to a
    # mesh multiple (_pad_axis_replicate)
    return -(-axis_len // n)


def plan_sharded(
    shape: Tuple[int, int, int],
    cfg: PNRConfig,
    n_devices: int,
    mem_bytes: Optional[int] = None,
    usable_fraction: float = 0.85,
    stage_iters: int = 8,
    blocked_frangi: Optional[bool] = None,
) -> ShardPlan:
    """Per-shard device-memory plan of `reconstruction_func_sharded` over
    `n_devices` shards. `mem_bytes` defaults to the card's
    (`card_memory_bytes`). `blocked_frangi=None` routes the filter as the
    pipeline does (`slab_filter_route`: the route with the lower planned
    peak); True/False forces the choice. `stage_iters`
    is the driver's (a larger one widens the trace halo)."""
    from pnr_tpu_torch.parallel.handoff import required_trace_halo
    from pnr_tpu_torch.parallel.sharded import frangi2d_halo, frangi_halo, slab_filter_route
    from pnr_tpu_torch.pipeline import reconstruct as rc

    if mem_bytes is None:
        mem_bytes = card_memory_bytes()
    z, y, x = (int(s) for s in shape)
    is2d = z == 1
    axis_len = y if is2d else z  # the sharded axis (Y for P == 1)
    plane = x if is2d else y * x  # voxels per sharded slice
    hf = frangi2d_halo(cfg.sigmas) if is2d else frangi_halo(cfg.sigmas, cfg.zdist)
    ht = required_trace_halo(cfg, stage_iters)
    ext = _shard_extent(axis_len, n_devices)
    padded = ext * n_devices
    vox = ext * plane  # owned voxels per shard
    slab_f = min(ext + 2 * hf, padded) * plane  # the filter's aligned halo slab
    slab_t = min(ext + 2 * ht, padded) * plane  # the tracer's aligned halo slab

    stages: Dict[str, int] = {}

    # --- filter: the shard's planes, the route's peak on its halo slab
    # (the slab counted in it) and the crop of its outputs
    if is2d:
        if blocked_frangi is None:
            blocked_frangi = slab_f > rc.FRANGI2D_TILED_PIXELS
        per = rc.FRANGI2D_TILED_PEAK_BYTES_PER_PIXEL if blocked_frangi else \
            rc.FRANGI2D_PEAK_BYTES_PER_PIXEL
        name = "frangi2d (tiled)" if blocked_frangi else "frangi2d"
        route = per * slab_f
    else:
        r = slab_filter_route((slab_f // plane, y, x), cfg.sigmas, cfg.zdist,
                              tiled=blocked_frangi)
        if not r.tiled:
            name = "frangi"
        elif r.blocks is not None:
            name = f"frangi (tiled, bz={r.blocks[0]}, by={r.blocks[1]})"
        else:
            name = "frangi (Z-blocked, bz=32)"
        route = r.peak_bytes
    stages[name] = int(vox + route + _CROP_B_PER_VOX * vox)

    # --- seeds: the shard's planes, J8 and the direction volumes (the
    # flood runs on the host)
    stages["seeds"] = int(vox + _SEED_MAPS_B_PER_VOX * vox)

    # --- likelihood field on the trace-halo slab, built next to that
    # slab, with the shard's planes and maps still live, and the lanes
    if cfg.zncc_mode == "tube":
        s = len(cfg.sigmas)
        bf16 = cfg.tube_map_dtype == "bf16" or (
            cfg.tube_map_dtype == "auto" and 12 * s * slab_t > 4 * (1 << 30))
        field = (6 if bf16 else 12) * s * slab_t
        build = rc.TUBE_BUILD_PEAK_BYTES_PER_VOXEL * slab_t + slab_t
    else:  # the exact engine samples the uint8 slab
        field, build = slab_t, 0
    lanes = 2 * max(64, cfg.wave_size)
    state = lanes * cfg.np * _TRACE_STATE_B_PER_LANE_PARTICLE
    stages[f"tracing ({cfg.zncc_mode})"] = int(
        vox + _SEED_MAPS_B_PER_VOX * vox + field + build + state)

    return ShardPlan(shape=(z, y, x), n_devices=n_devices, stages=stages,
                     mem_bytes=int(mem_bytes), usable_fraction=usable_fraction)


def min_devices(
    shape: Tuple[int, int, int],
    cfg: PNRConfig,
    mem_bytes: Optional[int] = None,
    max_devices: int = 8192,
    **kw,
) -> ShardPlan:
    """Smallest power-of-two mesh on which (shape, cfg) fits.

    Raises ValueError when even one-slice-per-shard shards don't fit: the
    slice plane is the irreducible resident (a 1-D mesh does not shard
    within a slice); the message says which stage binds."""
    if mem_bytes is None:
        mem_bytes = card_memory_bytes()
    n = 1
    while True:
        plan = plan_sharded(shape, cfg, n, mem_bytes=mem_bytes, **kw)
        if plan.fits:
            return plan
        axis_len = shape[1] if shape[0] == 1 else shape[0]
        if n >= max_devices or _shard_extent(axis_len, n) == 1:
            raise ValueError(
                f"volume {tuple(shape)} cannot fit {mem_bytes / (1 << 30):.1f} GiB cards on a "
                f"1-D mesh (tried up to {n} cards; binding stage: {plan.peak_stage} at "
                f"{plan.peak_bytes / (1 << 30):.2f} GiB/shard). The slab's per-slice plane is "
                "the irreducible resident: reduce sigmas (smaller halos), use "
                "zncc_mode='exact' (no tube maps), or tile the plane."
            )
        n *= 2
