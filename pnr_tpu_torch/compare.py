"""SWC comparison CLI: score one reconstruction against another.

    python -m pnr_tpu_torch.compare test.swc gold.swc [--dist 4.0] [--resample 1.0]

Prints one JSON line with precision/recall/F1/topology (the
density-invariant DIADEM-style matching of `utils.swc_compare` — both
morphologies are arclength-resampled before nearest-neighbour matching,
so node-count differences don't masquerade as recall loss). Exit code 0.

The reference ecosystem scores reconstructions with external DIADEM /
Vaa3D neuron_distance tools; a plugin user migrating here gets the
scoring built in (e.g. to compare against an existing Vaa3D-produced
SWC of the same stack).
"""

from __future__ import annotations

import argparse
import json
import sys

from pnr_tpu_torch.io.swc import read_swc
from pnr_tpu_torch.utils.swc_compare import compare_swc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pnr_tpu_torch.compare",
        description="score test.swc against gold.swc "
        "(density-invariant DIADEM-style matching)",
    )
    ap.add_argument("test", help="reconstruction to score (.swc)")
    ap.add_argument("gold", help="reference morphology (.swc)")
    ap.add_argument(
        "--dist", type=float, default=4.0,
        help="match radius in voxels (default 4.0)",
    )
    ap.add_argument(
        "--resample", type=float, default=1.0,
        help="arclength resampling step before matching; 0 disables "
        "(raw one-to-one matching understates recall when node "
        "densities differ — default 1.0)",
    )
    args = ap.parse_args(argv)
    try:
        test = read_swc(args.test)
        gold = read_swc(args.gold)
    except (OSError, ValueError) as e:
        sys.stderr.write(f"{e}\n")
        return 1
    s = compare_swc(test, gold, dist=args.dist, resample=args.resample)
    print(
        json.dumps(
            {
                "precision": round(s.precision, 4),
                "recall": round(s.recall, 4),
                "f1": round(s.f1, 4),
                "topology": round(s.topology, 4),
                "n_test": s.n_test,
                "n_gold": s.n_gold,
                "n_matched": s.n_matched,
                "dist": args.dist,
                "resample": args.resample,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
