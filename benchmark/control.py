#!/usr/bin/env python3
"""The control of ``correct``, on the card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--seconds 5]

For each seed, in one process: a run of the cell with a short window, its
answers held to the reference (the lower reading: the program's wrong
answers), and the control's answers for the same calls held to it (the
upper reading: the reference with every scalar's wire integer cut to its
low 240 bits, an ingest that drops the top 16-bit window).  One JSON line a
seed.  The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    from benchmark.core import harness
    for seed in args.seeds:
        out = harness.run(args.workload, seed, args.seconds, False,
                          device="cuda:0", root=ROOT, control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": out["correct"],
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control_correct": out["control"]["correct"],
            "control": {k: v["value"]
                        for k, v in out["control"]["checks"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
