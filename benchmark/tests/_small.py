"""Small stacks and short traces for the CPU tests: one arbor of short
segments in a (24, 96, 96) stack, one sigma, 30 iterations a trace."""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
SINGLE = json.load(open(os.path.join(HERE, "..", "traffic", "arbors-single.json")))
STACK = {**SINGLE["stack"], "shape": [24, 96, 96], "arbors": 1, "depth": 1, "seg_len": [25, 35]}
TRAFFIC = {"stack": STACK, "pool_stacks": 5, "warmup_stacks": 1}
CONFIG = {"sigmas": (2.0,), "ni": 30}
SEED = 2**31 + 1234567
