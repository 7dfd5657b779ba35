#!/usr/bin/env python3
"""Where the device time of the port's training steps goes.

Profiles one training step at batch 8 x 16,384 samples on one CUDA card
with torch.profiler: `--path teacher` (default) the `teacher_lj` train step
(mel, upsampler, the training stack's kernels 2 (kernel 5's accumulate
epilogue per layer) and 3, head, MoL loss, optimizer); `--path distill`
the `student_iaf` distillation step (4 student flows through kernels 2 and
3 with weight gradients, a seeded frozen teacher at teacher_lj's widths
through kernel 2 and kernel 3 dx-only, the STFT power loss, optimizer);
`--path direct` the `student_iaf` direct-training step.  Prints, beside
the card's name and power limit: the window's wall time per step, the
device time per kernel name, the host's self CPU time per op, the
training kernels' share (kernel 3's layer pass split by width), and the
device's idle share of the window.
Run from the repository root:

    python3 tools/torch_profile_train.py [--path distill] [--iters 5] [--trace out.json]
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
from pwn_tpu_torch.models.student import init_student  # noqa: E402
from pwn_tpu_torch.models.teacher import init_teacher  # noqa: E402
from pwn_tpu_torch.training.common import create_train_state  # noqa: E402
from pwn_tpu_torch.training.distill import make_distill_train_step  # noqa: E402
from pwn_tpu_torch.training.loop import frozen_teacher, make_val_batch  # noqa: E402
from pwn_tpu_torch.training.student_direct import (  # noqa: E402
    make_student_direct_train_step)
from pwn_tpu_torch.training.teacher import make_teacher_train_step  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402


def build_step(path: str, device):
    """(config, state, step) of one training path, seeded, on the card."""
    if path == "teacher":
        cfg = get_config("teacher_lj")
        model = init_teacher(cfg, torch.Generator().manual_seed(0),
                             stack_mode="train", device=device)
        state = create_train_state(dict(model.named_parameters()), cfg.train)
        return cfg, state, make_teacher_train_step(model, cfg)
    cfg = get_config("student_iaf")
    student = init_student(cfg, torch.Generator().manual_seed(1), device,
                           stack_mode="train")
    state = create_train_state(dict(student.named_parameters()), cfg.train)
    if path == "direct":
        return cfg, state, make_student_direct_train_step(student, cfg)
    teacher = frozen_teacher(cfg, init_teacher(
        cfg, torch.Generator().manual_seed(0), device=device).state_dict(),
        device)
    return cfg, state, make_distill_train_step(student, teacher, cfg)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("teacher", "distill", "direct"),
                    default="teacher")
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
    cfg, state, step = build_step(args.path, device)
    B = cfg.train.global_batch_size
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
    print(f"{smi}: {cfg.name} {args.path} train step B={B} x "
          f"{cfg.train.crop_samples}, "
          f"{n} steps: {wall / n * 1e3:.3f} ms per step (host clock, profiler "
          f"on), device busy {total_us / 1e3 / n:.3f} ms per step, idle share "
          f"{1 - total_us / 1e6 / wall:.3f}")
    for dev_us, count, key in rows[:20]:
        print(f"  {dev_us / 1e3 / n:8.3f} ms/step  {100 * dev_us / total_us:5.1f}%"
              f"  x{count // n:<4d} {key[:90]}")
    # the host's side: the ops whose own CPU time is largest (the card
    # idles while the host issues them)
    host = sorted((ev for ev in prof.key_averages()
                   if ev.self_cpu_time_total > 0),
                  key=lambda ev: ev.self_cpu_time_total, reverse=True)
    host_us = sum(ev.self_cpu_time_total for ev in host)
    print(f"host: {host_us / 1e3 / n:.3f} ms of self CPU time per step; "
          "largest:")
    for ev in host[:12]:
        print(f"  {ev.self_cpu_time_total / 1e3 / n:8.3f} ms/step  "
              f"x{ev.count // n:<5d} {ev.key[:80]}")
    # kernel 2 is kernel 5's accumulate epilogue once per layer
    # kernel 3's instantiations: DimsILi64E the student's, DimsILi128E the
    # teacher's widths (mangled template arguments)
    for name in ("gated_layer_kernel", "train_bwd_layer", "wgrad_gemm",
                 "wgrad_reduce", "train_bwd_finalize"):
        us = sum(r[0] for r in rows if name in r[2])
        print(f"{name}: {us / 1e3 / n:.3f} ms/step, share {us / total_us:.3f}")
        for tag, label in (("DimsILi64E", "student"), ("DimsILi128E", "teacher")):
            w_us = sum(r[0] for r in rows if name in r[2] and tag in r[2])
            if 0 < w_us < us:
                print(f"  at the {label}'s widths: {w_us / 1e3 / n:.3f} ms/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
