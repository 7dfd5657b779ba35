"""Read the numbers that decide `correct` over many seeds, in one process,
to set a cell's limits (`checks/<workload>.json`):

    python3 perfbench/calibrate.py --workload <name> --seeds 12 \
        --modes program,fp8,fault:answer --seconds 3 [--first-seed N]

Each mode runs the cell's driver on each seed with a short window:
"program" (sound runs: the lower readings), "fp8" (the control: the
reference in float8 in the program's place: the upper readings), and
"fault:<name>" (a fault planted in the program's timed path).  One JSON
line a run: mode, seed, the numbers compared, the end-to-end quantities.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    ap.add_argument("--modes", default="program,fp8")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import core

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for mode in args.modes.split(","):
        n = args.seeds if mode == "program" else min(args.seeds, 3)
        for k in range(n):
            seed = args.first_seed + 7919 * k
            fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
            ctx = core.Context(args.workload, seed, args.seconds, False,
                               candidate="fp8" if mode == "fp8" else "program",
                               fault=fault)
            t0 = time.monotonic()
            out, _ = core.driver(ctx).run(ctx)
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, "checks": out.checks,
                              "e2e": out.e2e, "setup_s": ctx.setup_s,
                              "run_s": time.monotonic() - t0,
                              "notes": {k: v for k, v in out.notes.items()
                                        if k != "launches"}},
                             default=float), flush=True)
            del out, ctx
    return 0


if __name__ == "__main__":
    sys.exit(main())
