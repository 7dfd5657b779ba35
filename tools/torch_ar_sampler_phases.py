#!/usr/bin/env python3
"""Where the time goes inside kernel 4 (`csrc/ar_sampler.cu`), and whether
the ranks of a cluster agree bit for bit.

Runs teacher_lj (24 layers, dilations 1..128, C=128, G=256, S=128, M=80,
10-component MoL, bf16 weights; random init from seed 0, the mixture
pinned as in chip_smoke.py) on one CUDA card, in builds of the kernel made
for this tool, and prints beside the card's name and power limit:

* us per step at batch 8 x 5,376 steps (CUDA events, one call each, in
  turns, twice) of the kernel as it is, of the phase-counter build and of
  a copy with a 3-stage weight ring in place of 4 (bf16);
* the clock cycles per step in each phase, from a build with
  PWN_AR_SAMPLER_PHASES: thread 0 of block 0 (rank 0 of row 0) adds them
  up.  The counting slows the kernel (its us per step is printed too), so
  these are shares, not times;
* a check build with PWN_AR_SAMPLER_CHECK, in which every rank of every
  cluster writes its samples to an (N, B, T) buffer: at batch 8 x 1,003
  steps the tool asserts that all N ranks agree bit for bit, and with
  wav, and exits non-zero if they do not.

Run from the repository root:

    python3 tools/torch_ar_sampler_phases.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch import get_config  # noqa: E402
from pwn_tpu_torch.models import sampling  # noqa: E402
from pwn_tpu_torch.models.teacher import init_teacher  # noqa: E402
from pwn_tpu_torch.ops import _build  # noqa: E402
from pwn_tpu_torch.ops.ar_sampler import (AR_RANKS, ar_launch_args,  # noqa: E402
                                          check_ar_args,
                                          stack_teacher_weights)
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402

SOURCE = _build.CSRC / "ar_sampler.cu"
# (text in the source, its replacement) for each copy with one choice changed
CHANGED = {"3-stage ring": [("STAGES = sizeof(W) == 2 ? 4 : 2;",
                             "STAGES = sizeof(W) == 2 ? 3 : 2;")]}
PIN = 25.0   # chip_smoke.py's AR_PIN: the MoL mixture pinned to component 0
B, T, T_CHECK = 8, 5376, 1003


def build(name: str, defines=(), subs=()) -> tuple:
    """Start compiling a copy of ar_sampler.cu, with `subs` applied and
    `defines` set, into a library of its own; returns the compiler's
    process and the library's path (the caller starts every build before
    it waits for any)."""
    text = SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    stem = "ar_tool_" + name.replace(" ", "_").replace("-", "_")
    cu = _build.BUILD_DIR / f"{stem}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    out = cu.with_suffix(".so")
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", *[f"-D{d}" for d in defines], "-o", str(out), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def load(proc, out: Path) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {out.name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    lib.pwn_ar_sample.argtypes = _build.AR_SAMPLE_ARGTYPES
    lib.pwn_ar_sample.restype = ctypes.c_int
    return lib


def main() -> int:
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    jobs = {"kernel": build("kernel"),
            "phase counters": build("phase counters", ("PWN_AR_SAMPLER_PHASES",)),
            "check": build("check", ("PWN_AR_SAMPLER_CHECK",))}
    jobs.update({k: build(k, subs=subs) for k, subs in CHANGED.items()})
    libs = {k: load(*job) for k, job in jobs.items()}
    counters = libs["phase counters"]
    counters.pwn_ar_sampler_phase_names.restype = ctypes.c_char_p
    names = counters.pwn_ar_sampler_phase_names().decode().split(";")

    cfg = get_config("teacher_lj")
    tc = cfg.teacher
    model = init_teacher(cfg, torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        model.stack.head2.bias[0] += PIN
    weights = stack_teacher_weights(model.stack, torch.bfloat16)
    kw = dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures, head=tc.output,
              log_scale_min=tc.log_scale_min, temperature=1.0)
    gen = torch.Generator(device=device).manual_seed(3)

    def inputs(steps):
        cond = torch.randn((B, steps, cfg.dsp.n_mels), generator=gen,
                           device=device) * 0.5
        return cond.bfloat16(), sampling.draw_noise(cfg, gen, steps, B)

    stream = torch.cuda.current_stream().cuda_stream

    def run(lib, cond, noise, wav_ranks=None):
        check_ar_args(cond, noise, weights, kw["dilations"], kw["n_mixtures"],
                      kw["head"])
        args, held = ar_launch_args(cond, noise, weights, wav_ranks=wav_ranks,
                                    **kw)
        err = lib.pwn_ar_sample(*args, stream)
        if err:
            raise RuntimeError(f"kernel 4: launch failed ({err})")
        return held[0]

    def time_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    cond, noise = inputs(T)
    timed = ("kernel", "phase counters", *CHANGED)
    with torch.inference_mode():
        for k in timed:
            run(libs[k], cond, noise)  # warm up
        torch.cuda.synchronize()
        ms = {k: [] for k in timed}
        for k in timed + timed[::-1] + timed + timed[::-1]:  # in turns, on one card
            ms[k].append(time_ms(lambda: run(libs[k], cond, noise)))
        for k in timed:
            print(f"{smi}: kernel 4 B={B} T={T} (N={AR_RANKS}), {k}: "
                  + " / ".join(f"{v:.3f}" for v in ms[k]) + " ms per call, "
                  + " / ".join(f"{v * 1e3 / T:.3f}" for v in ms[k])
                  + " us per step", flush=True)

        cycles = (ctypes.c_ulonglong * (len(names) + 1))()
        counters.pwn_ar_sampler_phases(cycles)  # clear
        run(counters, cond, noise)
        torch.cuda.synchronize()
        counters.pwn_ar_sampler_phases(cycles)
        steps = max(cycles[len(names)], 1)
        per_step = [cycles[k] / steps for k in range(len(names))]
        total = sum(per_step)
        print(f"{smi}: kernel 4 with phase counters, cycles per step (thread 0 "
              f"of block 0, {steps} steps, {total:.0f} a step, "
              f"{total / tc.n_layers:.0f} a layer): "
              + ", ".join(f"{n} {c:.0f} ({c / total:.3f})"
                          for n, c in zip(names, per_step)), flush=True)

        cond, noise = inputs(T_CHECK)
        wav_ranks = torch.full((AR_RANKS, B, T_CHECK), float("nan"),
                               device=device)
        wav = run(libs["check"], cond, noise, wav_ranks)
        torch.cuda.synchronize()
    same = [torch.equal(wav_ranks[r], wav_ranks[0]) for r in range(AR_RANKS)]
    print(f"{smi}: check build B={B} T={T_CHECK}: ranks equal to rank 0 bit "
          f"for bit {same}; rank 0 equal to wav {torch.equal(wav_ranks[0], wav)}; "
          f"{float((wav.abs() < 1).float().mean()):.3f} of the draws inside "
          f"(-1, 1)", flush=True)
    if not (all(same) and torch.equal(wav_ranks[0], wav)):
        print("the ranks of a cluster disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
