"""The readings that the limits of `correct` are set from: the port's
numbers on many seeds, the control's, and a planted fault's.

    python3 perfbench/calibrate.py --workload out2048.motion \
        --seeds 11 12 13 --control-seeds 11 12 13 [--fault-seeds 11 12 13]

In one process, at the cell's own sizes, each seed as a run of that seed
would compare it (the cell's driver's `calibration`): the port against the
reference; for the control seeds, the reference computed in TF32 (the
nearest precision below the configuration's float32 with TF32 off) against
the reference; for the fault seeds, where the driver has a fault to plant,
the reference with the fault against the reference. One JSON line a seed.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    cell = harness.find_cell(args.workload)
    for rec in cell.driver().calibration(cell, args.seeds, set(args.control_seeds),
                                         set(args.fault_seeds), torch.device("cuda", 0)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
