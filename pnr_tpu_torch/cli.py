"""Advantra-compatible command line for the PyTorch/CUDA port.

Same single-stack surface as pnr_tpu/cli.py (parity target
`Advantra::dofunc`, pnr-vaa3d/Advantra_plugin.cpp:274-337): the same 11
positional parameters after -p, the same validation and output naming
(<image>_Advantra.swc with the parameter-provenance header).

    python -m pnr_tpu_torch -i image.tif -p 2,4,6 0 5 0.3 3 2 200 20 2 4 1

`--device` defaults to `cuda` and fails when no card is present;
`--device cpu` runs the plain PyTorch versions of the kernels (for tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.io.swc import save_nodelist
from pnr_tpu_torch.io.volume import load_volume
from pnr_tpu_torch.utils.exporters import metrics_entry

#: options of pnr_tpu's CLI whose engines are not ported yet (ROADMAP.md)
_NOT_PORTED = (
    ("watch", "--watch"),
    ("checkpoint", "--checkpoint"),
    ("resume", "--resume"),
    ("mesh", "--mesh"),
    ("plan", "--plan"),
    ("save_midres", "--save-midres"),
    ("find_maxima", "--find-maxima"),
    ("interactive", "--interactive"),
)


def print_help_params() -> None:
    print(
        """*** PNR (Advantra), PyTorch/CUDA port: usage ***
python -m pnr_tpu_torch -i <inimg_file> -p <neuritesigmas somaradius tolerance znccth kappa step ni np zdist nodepervol vol> [-o out.swc] [--metrics M] [--zncc-mode exact|tube] [--quiet] [--device cuda]
inimg_file     The input image (.tif / .v3draw / .npy).
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pnr_tpu_torch", add_help=False)
    ap.add_argument("-i", dest="images", nargs="+", default=None)
    ap.add_argument("-p", dest="params", nargs="*", default=None)
    ap.add_argument("-o", dest="output", default=None,
                    help="output SWC file path (default: <image>_Advantra.swc)")
    ap.add_argument("--metrics", default=None,
                    help="write the stage timings and counts as JSON")
    ap.add_argument("--zncc-mode", choices=("exact", "tube"), default="exact",
                    help="likelihood engine: 'exact' (reference parity) or 'tube' "
                         "(precomputed-map approximation)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("-h", "--help", action="store_true")
    ap.add_argument("--save-midres", action="store_true")
    ap.add_argument("--find-maxima", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--watch", action="store_true")
    ap.add_argument("--plan", action="store_true")
    ap.add_argument("--interactive", action="store_true")
    args = ap.parse_args(argv)

    if args.help or not args.images:
        print_help_params()
        return 0 if args.help else 1
    for attr, flag in _NOT_PORTED:
        if getattr(args, attr):
            sys.stderr.write(f"{flag} is not yet ported to pnr_tpu_torch (see ROADMAP.md)\n")
            return 2
    if len(args.images) > 1:
        sys.stderr.write("several input stacks (batch serving) are not yet ported "
                         "to pnr_tpu_torch (see ROADMAP.md)\n")
        return 2
    if args.params is None or len(args.params) != 11:
        sys.stderr.write("\nNeeds 11 input parameters.\n\n")
        print_help_params()
        return 1
    try:
        cfg = PNRConfig.from_cli_params(args.params)
    except ValueError as e:
        sys.stderr.write(f"{e}\n")
        return 1
    cfg = dataclasses.replace(cfg, zncc_mode=args.zncc_mode)

    from pnr_tpu_torch.pipeline import reconstruction_func
    from pnr_tpu_torch.utils.runtime import require_cuda

    image = args.images[0]
    try:
        device = require_cuda(args.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"{e}\n")
        return 1
    verbose = not args.quiet
    if verbose:
        print("-------------  PNR (PyTorch/CUDA port)  -------------")
        for k in ("sigmas", "somaradius", "tolerance", "znccth", "kappa", "step",
                  "ni", "np", "zdist", "nodepervol", "vol", "zncc_mode"):
            print(f"{k} = {getattr(cfg, k)}")
        print(f"device = {device}")
        print("-----------------------------------------------------")

    vol = load_volume(image)
    result = reconstruction_func(vol, cfg, verbose=verbose, device=device)
    out = args.output or (image + "_Advantra.swc")
    save_nodelist(result.tree, out, ntype=-1, sig2r=1.0, name="Advantra",
                  comment=cfg.provenance_comment())
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump({"params": cfg.provenance_comment(),
                       "stacks": [metrics_entry(image, result)]}, f, indent=1)
            f.write("\n")
    if verbose:
        print(f"wrote {out} ({len(result.tree) - 1} nodes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
