"""Configuration for the PNR-TPU reconstruction pipeline.

Mirrors the reference's 11 positional CLI parameters (`input_PARA`,
pnr-vaa3d/Advantra_plugin.cpp:88-103, defaults at :48-83) plus the
file-scope "expert" constants that act as hidden flags in the
reference. One dataclass, used by both the Python API and the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class PNRConfig:
    # --- the 11 CLI parameters (reference defaults, Advantra_plugin.cpp:48-58) ---
    #: Gaussian cross-section sigmas for neurite filtering/tracking (sorted).
    sigmas: Tuple[float, ...] = (2.0, 3.0)
    #: Minimum soma radius; 0 disables soma detection.
    somaradius: int = 0
    #: Local-maxima tolerance for seed extraction (ImageJ MaximumFinder).
    tolerance: float = 10.0
    #: ZNCC correlation threshold (stops traces / filters seeds).
    znccth: float = 0.5
    #: von Mises concentration of the directional transition prior.
    kappa: float = 2.0
    #: Prediction step (pixels) of the SMC transition.
    step: int = 3
    #: Number of SMC iterations per trace.
    ni: int = 100
    #: Number of particles per trace.
    np: int = 20
    #: Distance between z-layers in pixels (anisotropy).
    zdist: float = 2.0
    #: Max node visits per voxel before trace suppression.
    nodepervol: int = 4
    #: Suppression neighbourhood size: 1, 5, 9, 11, 19, or 27 voxels.
    vol: int = 9

    # --- expert constants (reference file-scope globals, Advantra_plugin.cpp:61-83) ---
    save_midres: bool = False
    #: Likelihood factor: lhood = exp(Kc * zncc).
    kc: float = 20.0
    #: Resample when Neff/np falls below this ratio.
    neff_ratio: float = 0.8
    frangi_alpha: float = 0.5
    frangi_beta: float = 0.5
    frangi_c: float = 500.0
    frangi_betaone: float = 0.5
    frangi_betatwo: float = 15.0
    max_trace_count: int = 5000
    epsilon2: float = 1e-4
    refine_iter: int = 4
    #: Neighbourhood radius multiplier for refinement (radius = SIG2RADIUS * sigma).
    sig2radius: float = 1.5
    #: Trace resampling step during node interpolation.
    trace_rsmpl: float = 1.0
    #: Node grouping radius.
    group_radius: float = 2.0
    enforce_single_tree: bool = False
    tree_size_min: int = 10
    tail_size_min: int = 2
    #: Apply tail pruning (remove_tails) in post-processing. The reference
    #: implements it but never calls it on the live path
    #: (Advantra_plugin.cpp:2179, commented out) — off by default.
    prune_tails: bool = False

    # --- TPU-native additions (no reference equivalent) ---
    #: Number of seeds advanced in lockstep per wave (each seed traces two
    #: directions, so the device batch is 2x this). 128 is the validated
    #: sweet spot on TPU v5e: larger waves blow up XLA compile time.
    wave_size: int = 128
    #: PRNG seed (the reference used srand(time(NULL)); we are reproducible).
    seed: int = 0
    #: ZNCC likelihood engine: "exact" evaluates the reference's template
    #: sampling at full sample count (znccBBB parity) through the fused
    #: Pallas patch kernel (ops/zncc_exact.py; ~2.4x slower than tube on
    #: v5e); "tube" uses the precomputed-map approximation
    #: (ops/zncc_fast.py), validated to track the exact correlation on
    #: tubular structures.
    zncc_mode: str = "exact"
    #: Add the bf16 lo-correction matmul pass to the exact-ZNCC Pallas
    #: kernel's hat weights (two MXU passes instead of one). Off by
    #: default: the single-pass correlation error vs f32 is <= 2.4e-4
    #: (p99 1.3e-4, zero sigma-argmax flips on noisy tube volumes) — an
    #: order of magnitude inside this engine's 2e-3 agreement with the
    #: compiled reference, while single-pass is ~1.6x faster (374k vs
    #: 234k particle-updates/s at the default sigmas on v5e). Set True
    #: for the float-grade kernel (agrees with the f32 gather to ~5e-6).
    zncc_exact_hilo: bool = False
    #: Run the dense filter through the fully-fused Pallas Frangi kernel
    #: (ops/frangi_fused.py: one raw-volume read, per-sigma VMEM plane
    #: rings, ~1.6x the unfused path on v5e). On by default since round
    #: 3 (oracle-parity tested, TPU-validated, automatic geometry
    #: ladder); set False for the unfused bit-for-bit parity reference —
    #: the fused kernel matches it to fp noise on structured signal
    #: (tests/test_frangi_fused.py). Env PNR_TPU_FUSED_FRANGI=1 forces
    #: it on. Falls back automatically off-TPU / when no tile geometry
    #: fits VMEM.
    fused_frangi: bool = True
    #: Tube mode: how many consecutive SMC iterations one per-trace
    #: patch extraction feeds (smc/tracker one_iter). The engine widens
    #: its windows by (patch_reuse-1)*step so the clamping contract
    #: holds against the stale corner; correlation values for in-window
    #: samples are identical to patch_reuse=1 — only far outliers
    #: (negligible weight by construction) clamp differently.
    #: Measured on v5e: NO win (929k updates/s at 1 vs 877k at 2 at the
    #: reference config) — the hat-sample kernel re-reads the whole
    #: patch every iteration, so reuse only removes the (smaller) write
    #: side while widening every read. Kept as a knob for runtimes
    #: where extraction launches, not bytes, dominate. 1 = extract
    #: every iteration (the strict formulation, default).
    #: Semantics at >1: reuse groups align to each device stage launch,
    #: so STAGED and MONOLITHIC runs may differ in which iterations
    #: share an extraction (both stay inside the clamping contract;
    #: default staging is deterministic run-to-run). The sharded and
    #: handoff paths force 1 — their halo budget assumes the strict
    #: windows and their stage boundaries differ from single-device.
    patch_reuse: int = 1
    #: Tube-mode map-field dtype: "auto" keeps the f32 field below
    #: ~4 GB of maps and switches to the Z-streamed bfloat16 field
    #: beyond (6*S B/voxel — lifts the fast engine's single-chip cap
    #: from ~250-350 Mvox to the half-Gvox class at a measured 1.8e-3
    #: max corr error / 0.13% sigma flips vs f32; see
    #: ops/zncc_fast.build_tube_maps_packed_blocked). "f32"/"bf16"
    #: force an engine.
    tube_map_dtype: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "sigmas", tuple(sorted(float(s) for s in self.sigmas)))
        if self.somaradius < 0:
            raise ValueError("somaradius out of range")
        if self.tolerance < 0:
            raise ValueError("tolerance out of range")
        if not (0 <= self.znccth <= 1):
            raise ValueError("znccth out of range")
        if not (0 <= self.kappa <= 5):
            raise ValueError("kappa out of range")
        if self.step < 1:
            raise ValueError("step out of range")
        if self.ni <= 0:
            raise ValueError("ni out of range")
        if self.np <= 0:
            raise ValueError("np out of range")
        if self.zdist < 1:
            raise ValueError("zdist out of range")
        if not (2 < self.nodepervol <= 20):
            raise ValueError("nodepervol out of range")
        if self.vol not in (1, 5, 9, 11, 19, 27):
            raise ValueError("vol can be 1,5,9,11,19,27")
        if self.zncc_mode not in ("exact", "tube"):
            raise ValueError("zncc_mode must be 'exact' or 'tube'")
        if self.patch_reuse < 1:
            raise ValueError("patch_reuse out of range")
        if self.tube_map_dtype not in ("auto", "f32", "bf16"):
            raise ValueError("tube_map_dtype must be 'auto', 'f32' or 'bf16'")

    @classmethod
    def from_cli_params(cls, params: Sequence[str]) -> "PNRConfig":
        """Parse the reference's 11 positional parameters.

        Order (Advantra_plugin.cpp:301-313): neuritesigmas somaradius
        tolerance znccth kappa step ni np zdist nodepervol vol.
        """
        if len(params) != 11:
            raise ValueError(f"needs 11 input parameters, got {len(params)}")
        return cls(
            sigmas=tuple(float(s) for s in str(params[0]).split(",") if s),
            somaradius=int(params[1]),
            tolerance=float(params[2]),
            znccth=float(params[3]),
            kappa=float(params[4]),
            step=int(params[5]),
            ni=int(params[6]),
            np=int(params[7]),
            zdist=float(params[8]),
            nodepervol=int(params[9]),
            vol=int(params[10]),
        )

    def provenance_comment(self, channel: int = 1) -> str:
        """Parameter provenance embedded in the SWC header.

        Reproduces the reference's COMMENT feature
        (Advantra_plugin.cpp:2277-2306): every parameter, including the
        internal constants, recorded with the output.
        """
        sigstr = ",".join(f"{s:g}" for s in self.sigmas)
        fields = [
            ("channel", channel),
            ("neuritesigmas", sigstr),
            ("somaradius", self.somaradius),
            ("tolerance", f"{self.tolerance:g}"),
            ("znccth", f"{self.znccth:g}"),
            ("kappa", f"{self.kappa:g}"),
            ("step", self.step),
            ("ni", self.ni),
            ("np", self.np),
            ("zdist", f"{self.zdist:g}"),
            ("nodepervol", self.nodepervol),
            ("vol", self.vol),
            ("------------------------", ""),
            ("Kc", f"{self.kc:g}"),
            ("neff_ratio", f"{self.neff_ratio:g}"),
            ("frangi_alfa", f"{self.frangi_alpha:g}"),
            ("frangi_beta", f"{self.frangi_beta:g}"),
            ("frangi_C", f"{self.frangi_c:g}"),
            ("frangi_betaone", f"{self.frangi_betaone:g}"),
            ("frangi_betatwo", f"{self.frangi_betatwo:g}"),
            ("MAX_TRACE_COUNT", self.max_trace_count),
            ("EPSILON2", f"{self.epsilon2:g}"),
            ("REFINE_ITER", self.refine_iter),
            ("SIG2RADIUS", f"{self.sig2radius:g}"),
            ("TRACE_RSMPL", f"{self.trace_rsmpl:g}"),
            ("GROUP_RADIUS", f"{self.group_radius:g}"),
            ("ENFORCE_SINGLE_TREE", int(self.enforce_single_tree)),
            ("TREE_SIZE_MIN", self.tree_size_min),
            ("TAIL_SIZE_MIN", self.tail_size_min),
        ]
        lines = ["params:"]
        for k, v in fields:
            lines.append(f"{k}={v}" if v != "" else k)
        return "\n#".join(lines)
