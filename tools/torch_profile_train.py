#!/usr/bin/env python3
"""Where the device time of the port's teacher training step goes.

Profiles the `teacher_lj` train step (mel, upsampler, the training stack's
kernels 2 (kernel 5's accumulate epilogue per layer) and 3, head, MoL loss,
optimizer) at batch 8 x 16,384 samples on
one CUDA card with torch.profiler and prints, beside the card's name and
power limit: the window's wall time per step, the device time per kernel
name, the training kernels' share, and the device's idle share of the
window.  Run from the repository root:

    python3 tools/torch_profile_train.py [--iters 5] [--trace out.json]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch import get_config  # noqa: E402
from pwn_tpu_torch.models.teacher import init_teacher  # noqa: E402
from pwn_tpu_torch.training.common import create_train_state  # noqa: E402
from pwn_tpu_torch.training.loop import make_val_batch  # noqa: E402
from pwn_tpu_torch.training.teacher import make_teacher_train_step  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    cfg = get_config("teacher_lj")
    B = cfg.train.global_batch_size
    model = init_teacher(cfg, torch.Generator().manual_seed(0),
                         stack_mode="train", device=device)
    state = create_train_state(dict(model.named_parameters()), cfg.train)
    step = make_teacher_train_step(model, cfg)
    wav = torch.from_numpy(make_val_batch(cfg, None, B)).to(device)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        step(state, wav)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(args.iters):
            step(state, wav)
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
    n = args.iters
    print(f"{smi}: teacher_lj train step B={B} x {cfg.train.crop_samples}, "
          f"{n} steps: {wall / n * 1e3:.3f} ms per step (host clock, profiler "
          f"on), device busy {total_us / 1e3 / n:.3f} ms per step, idle share "
          f"{1 - total_us / 1e6 / wall:.3f}")
    for dev_us, count, key in rows[:20]:
        print(f"  {dev_us / 1e3 / n:8.3f} ms/step  {100 * dev_us / total_us:5.1f}%"
              f"  x{count // n:<4d} {key[:90]}")
    # kernel 2 is kernel 5's accumulate epilogue once per layer
    for name in ("gated_layer_kernel", "train_bwd_layer", "wgrad_gemm",
                 "wgrad_reduce", "train_bwd_finalize"):
        us = sum(r[0] for r in rows if name in r[2])
        print(f"{name}: {us / 1e3 / n:.3f} ms/step, share {us / total_us:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
