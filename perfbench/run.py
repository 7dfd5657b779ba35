"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`, and
with --trace 1 `breakdown`; the numbers compared last, under `checks`).
The run fails, printing no result, without a CUDA card, with fewer cards
than the cell asks for, when the program is missing, or when the process
has loaded JAX, flax or the JAX package by the time the window closes.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".perfbench_cache"


def _environment() -> None:
    """Kernel caches at fixed paths inside the checkout; libraries that
    would load JAX by themselves told not to."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from perfbench import core

    man = core.manifest(ROOT)
    chips = core.workload_entry(man, args.workload)["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    import pwn_tpu_torch  # noqa: F401  (a checkout without it fails here)

    ctx = core.Context(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=T_START)
    out, trace_obj = core.driver(ctx).run(ctx)
    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    line = core.result_line(ctx, out, trace_obj)
    for k, v in {**out.notes, "host": ctx.host}.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for name, row in line["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
