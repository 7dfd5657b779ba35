#!/usr/bin/env python3
"""Where the device time of the port's student synthesis goes.

Profiles `StudentIAF.generate` for a student preset (`student_iaf`, whose
flows run the whole-stack kernel 1, or `large_student_sharded`, whose flows
run kernel 5's accumulate epilogue once per layer) at batch 8 x 2 s on one
CUDA card with torch.profiler and prints, beside the card's name and power
limit: the window's wall time per call, the device time per kernel name,
the stack kernels' share, kernel 5's time split by epilogue, and the
device's idle share of the window.  `--fused-layers layer` profiles the
per-layer mode instead (kernel 5's "layer" epilogue).  Run from the
repository root:

    python3 tools/torch_profile_generate.py [--config student_iaf]
        [--fused-layers auto] [--iters 5] [--trace out.json]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch import get_config, override  # noqa: E402
from pwn_tpu_torch.models.student import init_student  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="student_iaf",
                    choices=("student_iaf", "large_student_sharded"))
    ap.add_argument("--fused-layers", default=None,
                    choices=("auto", "mega", "layer"),
                    help="override the preset's student.fused_layers")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the window here")
    args = ap.parse_args()

    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = get_config(args.config)
    if args.fused_layers:
        cfg = override(cfg, "student.fused_layers", args.fused_layers)
    hop, sr, B = cfg.dsp.hop_length, cfg.dsp.sample_rate, 8
    frames = int(2.0 * sr) // hop
    model = init_student(cfg, torch.Generator().manual_seed(0), device).eval()
    mel = torch.rand((B, frames, cfg.dsp.n_mels), device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(2):
            model.generate(gen, mel)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            for _ in range(args.iters):
                model.generate(gen, mel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    if args.trace:
        prof.export_chrome_trace(args.trace)

    # device-side kernel events only: an aten op's entry repeats the device
    # time of the kernels it launched
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    if total_us == 0:
        raise RuntimeError("the profiler recorded no device time")
    per_call_ms = wall / args.iters * 1e3
    print(f"{smi}: {cfg.name} generate B={B} x 2 s (stack modes "
          f"{sorted({f.mode for f in model.flows})}), {args.iters} calls: "
          f"{per_call_ms:.3f} ms per call (host clock, profiler on), "
          f"device busy {total_us / 1e3 / args.iters:.3f} ms per call, "
          f"idle share {1 - total_us / 1e6 / wall:.3f}")
    for dev_us, count, key in rows[:15]:
        print(f"  {dev_us / 1e3 / args.iters:8.3f} ms/call  "
              f"{100 * dev_us / total_us:5.1f}%  x{count // args.iters:<4d} "
              f"{key[:90]}")
    for name in ("flow_stack_kernel", "gated_layer_kernel"):
        share = sum(r[0] for r in rows if name in r[2]) / total_us
        print(f"{name} share of device time: {share:.3f}")
    # kernel 5's two epilogues are two instantiations, told apart by name
    for epilogue, tag in (("layer", ", false>"), ("accumulate", ", true>")):
        hits = [r for r in rows if "gated_layer_kernel" in r[2] and tag in r[2]]
        if hits:
            us, n = sum(r[0] for r in hits), sum(r[1] for r in hits)
            print(f"gated_layer_kernel, {epilogue} epilogue: "
                  f"{us / 1e3 / args.iters:.3f} ms/call over "
                  f"{n // args.iters} launches ({us / n / 1e3:.3f} ms each)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
