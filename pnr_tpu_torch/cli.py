"""Advantra-compatible command line for the PyTorch/CUDA port.

The surface of pnr_tpu/cli.py (parity target `Advantra::dofunc`,
pnr-vaa3d/Advantra_plugin.cpp:274-337): the same 11 positional parameters
after -p, the same validation and output naming (<image>_Advantra.swc
with the parameter-provenance header), and the same modes: several -i
inputs through the prefetch-pipelined `reconstruction_batch`, `--watch`
(serve a directory), `--checkpoint`/`--resume`, `--save-midres` (the
reference's intermediate dumps), `--find-maxima`, `--interactive`,
`--mesh N` (one input over N cards, `reconstruction_func_sharded`; with
`--watch`, each poll's arrivals over the mesh through
`reconstruction_batch_sharded`) and
`--plan` (the per-card memory plan, read from the image's header only).
Every stack runs on the device, but where the caller sets
PNR_TPU_HOST_PATH=1: a single stack (no --mesh, --watch, --checkpoint,
--resume or --save-midres, as in JAX) then runs on the host one-shot
engine (`pnr_tpu_torch.hostpath`). JAX's automatic route of small stacks
to that engine is not ported: it would run on the CPU unasked.

    python -m pnr_tpu_torch -i image.tif -p 2,4,6 0 5 0.3 3 2 200 20 2 4 1

`--device` defaults to `cuda` and fails when no card is present;
`--device cpu` runs the plain PyTorch versions of the kernels (for tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.io.swc import save_nodelist
from pnr_tpu_torch.io.volume import load_volume, save_volume
from pnr_tpu_torch.utils.exporters import metrics_entry

def print_help_params() -> None:
    print(
        """*** PNR (Advantra), PyTorch/CUDA port: usage ***
python -m pnr_tpu_torch -i <inimg_file> [more images] -p <neuritesigmas somaradius tolerance znccth kappa step ni np zdist nodepervol vol> [-o out.swc] [--metrics M] [--zncc-mode exact|tube] [--checkpoint C.npz [--resume]] [--save-midres] [--find-maxima] [--watch] [--interactive] [--mesh N] [--plan] [--quiet] [--device cuda]
inimg_file     The input image (.tif / .v3draw / .npy); with --watch, a directory.
neuritesigmas  Comma-delimited Gaussian cross-section sigmas.
somaradius     Minimum soma radius (0: no soma detection).
tolerance      Local maxima tolerance (typically 10).
znccth         Correlation threshold (0.5).
kappa          Von Mises concentration (2).
step           Prediction step (3).
ni             Number of trace iterations (100).
np             Number of trace particles (20).
zdist          Z-axis layer distance (2).
nodepervol     Nodes per volume limit (3+).
vol            Suppression volume: 1, 5, 9, 11, 19, 27.
Output SWC is named automatically from the input image file name."""
    )


def _write_metrics(path: str, cfg: PNRConfig, entries: list) -> None:
    with open(path, "w") as f:
        json.dump({"params": cfg.provenance_comment(), "stacks": entries}, f, indent=1)
        f.write("\n")


def _save_swc(tree, out: str, cfg: PNRConfig) -> None:
    save_nodelist(tree, out, ntype=-1, sig2r=1.0, name="Advantra",
                  comment=cfg.provenance_comment())


def _save_midres(image: str, result) -> None:
    """The reference's saveMidres artifacts (Advantra_plugin.cpp:2098-2141
    and the seed, J8, direction, density and soma dumps), named as
    pnr_tpu/cli.py names them."""
    from pnr_tpu_torch.utils.exporters import (
        export_directionality_swc,
        export_seeds_swc,
        save_vector,
    )

    save_volume(image + "_J8.tif", result.j8)
    export_seeds_swc(image + "_Seeds.swc", result.seeds_pos, corr=result.seeds_corr)
    mid = result.midres or {}
    if "vx" in mid:
        export_directionality_swc(image + "_VxVyVz.swc", result.j8, mid["vx"], mid["vy"],
                                  mid["vz"])
    if "trace_density" in mid:
        save_volume(image + "_TraceDensity.tif", mid["trace_density"])
    if "smap8" in mid:
        save_volume(image + "_Smap.v3dpbd", mid["smap8"])
    # the empty trailing suffix matches the reference's reconstruct(n0, prefix, "")
    for name in ("n0", "n0tree", "n0res", "n1", "n2", "n2tree"):
        if name in mid:
            save_nodelist(mid[name], f"{image}_{name}_.swc")
    for name in ("n0len", "n0corr", "n1len"):
        if name in mid:
            save_vector(mid[name], f"{image}_{name}_.log")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pnr_tpu_torch", add_help=False)
    ap.add_argument("-i", dest="images", nargs="+", default=None,
                    help="input image(s); several stream through the batch driver, one "
                         "_Advantra.swc per input")
    ap.add_argument("-p", dest="params", nargs="*", default=None)
    ap.add_argument("-o", dest="output", default=None,
                    help="output SWC file path (default: <image>_Advantra.swc); with --watch, "
                         "an output directory")
    ap.add_argument("--metrics", default=None,
                    help="write the stage timings, the part spans and counts as JSON (with "
                         "--watch, one JSON line per stack)")
    ap.add_argument("--zncc-mode", choices=("exact", "tube"), default="exact",
                    help="likelihood engine: 'exact' (reference parity) or 'tube' "
                         "(precomputed-map approximation)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("-h", "--help", action="store_true")
    ap.add_argument("--save-midres", action="store_true",
                    help="also write the reference's intermediate results")
    ap.add_argument("--find-maxima", action="store_true",
                    help="write the raw image's local maxima as SWC and exit (host only)")
    ap.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    ap.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the multi-device pipeline over N cards, cuda:0 ... N-1 (0 or 1: "
                         "one device; with --device cpu, N CPU shards)")
    ap.add_argument("--watch", action="store_true",
                    help="serve mode: -i names a directory; reconstruct stacks as they arrive "
                         "until <dir>/.stop appears")
    ap.add_argument("--plan", action="store_true",
                    help="print the per-card memory plan for reconstructing -i over --mesh N "
                         "cards (or the smallest mesh that fits, when --mesh is 0) and exit; "
                         "reads the image's header only")
    ap.add_argument("--interactive", action="store_true",
                    help="prompt for the 11 parameters with the reference defaults")
    args = ap.parse_args(argv)

    if args.help or not args.images:
        print_help_params()
        return 0 if args.help else 1
    image = args.images[0]
    if len(args.images) > 1:
        for bad, why in (
            (args.find_maxima, "--find-maxima"),
            (args.checkpoint, "--checkpoint"),
            (args.mesh, "--mesh"),
            (args.output, "-o"),
            (args.save_midres, "--save-midres"),
        ):
            if bad:
                sys.stderr.write(f"{why} takes a single input image\n")
                return 1
    if args.find_maxima and args.metrics:
        sys.stderr.write("--metrics is not supported with --find-maxima\n")
        return 1

    if args.interactive:
        from pnr_tpu_torch.ui import prompt_parameters

        try:
            cfg = prompt_parameters()
        except ValueError as e:
            sys.stderr.write(f"{e}\n")
            return 1
        if cfg is None:
            return 1  # cancelled
    else:
        if args.params is None or len(args.params) != 11:
            sys.stderr.write("\nNeeds 11 input parameters.\n\n")
            print_help_params()
            return 1
        try:
            cfg = PNRConfig.from_cli_params(args.params)
        except ValueError as e:
            sys.stderr.write(f"{e}\n")
            return 1
    if args.save_midres:
        cfg = dataclasses.replace(cfg, save_midres=True)
    cfg = dataclasses.replace(cfg, zncc_mode=args.zncc_mode)

    if args.watch:
        if len(args.images) != 1 or not os.path.isdir(image):
            sys.stderr.write("--watch takes a single directory after -i\n")
            return 1
        for bad, why in (
            (args.find_maxima, "--find-maxima"),
            (args.checkpoint, "--checkpoint"),
            (args.save_midres, "--save-midres"),
        ):
            if bad:
                sys.stderr.write(f"{why} is not supported with --watch\n")
                return 1
        if args.output and args.output.lower().endswith(".swc"):
            # in serve mode -o is a directory
            sys.stderr.write("--watch writes one SWC per arriving stack: -o must name an "
                             "output directory, not a .swc file\n")
            return 1

    if args.plan:
        # the image's header only: no voxel is read
        from pnr_tpu_torch.io.volume import probe_volume_shape
        from pnr_tpu_torch.parallel.plan import card_memory_bytes, min_devices, plan_sharded

        try:
            shape = probe_volume_shape(image)
            mem = card_memory_bytes(args.device)
            if args.mesh and args.mesh > 0:
                plan = plan_sharded(shape, cfg, args.mesh, mem)
            else:
                plan = min_devices(shape, cfg, mem)
        except (OSError, ValueError, RuntimeError) as e:
            sys.stderr.write(f"{e}\n")
            return 1
        print(plan.summary())
        return 0 if plan.fits else 1

    if args.find_maxima:
        # host only: the raw image's local maxima (the reference's
        # findMaxima path, Advantra_plugin.cpp:2308-2327)
        from pnr_tpu_torch.seeds.extract import max_points_host
        from pnr_tpu_torch.utils.exporters import export_points_swc

        vol = load_volume(image)
        mask = max_points_host(vol, cfg.tolerance)
        zz, yy, xx = np.nonzero(mask)
        out = args.output or f"{image}_findMaxima_{cfg.tolerance:g}.swc"
        export_points_swc(out, np.stack([xx, yy, zz], axis=-1), ntype=13, radius=0.1)
        print(f"{len(xx)} local maxima -> {out}")
        return 0

    verbose = not args.quiet
    if (os.environ.get("PNR_TPU_HOST_PATH") == "1" and len(args.images) == 1 and not args.watch
            and not (args.mesh and args.mesh > 1)
            and not (args.checkpoint or args.resume or cfg.save_midres)):
        # asked for: the one-shot host engine (NumPy, SciPy and the native
        # runtime), no device
        from pnr_tpu_torch.hostpath import host_reconstruction_func

        if verbose:
            print("host one-shot engine (PNR_TPU_HOST_PATH=1)")
        result = host_reconstruction_func(load_volume(image), cfg, verbose=verbose)
        out = args.output or (image + "_Advantra.swc")
        _save_swc(result.tree, out, cfg)
        if args.metrics:
            _write_metrics(args.metrics, cfg, [metrics_entry(image, result)])
        if verbose:
            print(f"wrote {out} ({len(result.tree) - 1} nodes)")
        return 0

    from pnr_tpu_torch.pipeline import (
        reconstruction_batch,
        reconstruction_func,
        watch_and_reconstruct,
    )
    from pnr_tpu_torch.utils.runtime import require_cuda

    try:
        device = require_cuda(args.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"{e}\n")
        return 1
    if verbose:
        print("-------------  PNR (PyTorch/CUDA port)  -------------")
        for k in ("sigmas", "somaradius", "tolerance", "znccth", "kappa", "step",
                  "ni", "np", "zdist", "nodepervol", "vol", "zncc_mode"):
            print(f"{k} = {getattr(cfg, k)}")
        print(f"device = {device}")
        print("-----------------------------------------------------")

    mesh = None
    if args.mesh and args.mesh > 1:
        from pnr_tpu_torch.parallel import make_mesh

        try:
            mesh = make_mesh(args.mesh, device=device)
        except ValueError as e:
            sys.stderr.write(f"{e}\n")
            return 1

    if args.watch:
        n = watch_and_reconstruct(image, cfg, out_dir=args.output, verbose=verbose, mesh=mesh,
                                  metrics_path=args.metrics, device=device)
        if verbose:
            print(f"serve: done, {n} stacks")
        return 0

    if len(args.images) > 1:
        # every stack through the batch driver (one tracer, prefetched
        # fronts), one SWC per input
        vols = (load_volume(p) for p in args.images)
        entries = []
        for path, result in zip(args.images,
                                reconstruction_batch(vols, cfg, verbose=verbose, device=device)):
            out = path + "_Advantra.swc"
            _save_swc(result.tree, out, cfg)
            entries.append(metrics_entry(path, result))
            if verbose:
                print(f"wrote {out} ({len(result.tree) - 1} nodes)")
        if args.metrics:
            _write_metrics(args.metrics, cfg, entries)
        return 0

    vol = load_volume(image)
    if mesh is not None:
        from pnr_tpu_torch.pipeline import reconstruction_func_sharded

        result = reconstruction_func_sharded(vol, cfg, mesh, verbose=verbose,
                                             checkpoint_path=args.checkpoint, resume=args.resume)
    else:
        result = reconstruction_func(vol, cfg, verbose=verbose,
                                     checkpoint_path=args.checkpoint, resume=args.resume,
                                     device=device)
    out = args.output or (image + "_Advantra.swc")
    _save_swc(result.tree, out, cfg)
    if args.metrics:
        _write_metrics(args.metrics, cfg, [metrics_entry(image, result)])
    if verbose:
        print(f"wrote {out} ({len(result.tree) - 1} nodes)")
    if cfg.save_midres:
        _save_midres(image, result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
