#!/usr/bin/env python3
"""Where the time goes inside kernel 4 (`csrc/ar_sampler.cu`), and whether
the ranks of a cluster agree bit for bit.

Runs teacher_lj (24 layers, dilations 1..128, C=128, G=256, S=128, M=80,
10-component MoL; random init from seed 0, the mixture pinned as in
chip_smoke.py) or, with --widths wide, the wide teacher (the same with
C=256, G=512, S=256), or, with --widths generic, the CLI's unbuilt
(96, 192, 96, 80) on the general body (batch 1, the CLI's own shape), in
bf16 weights or, with --weights fp32, fp32, on one CUDA card, in builds of
the kernel made for this tool; --body generic runs teacher_lj's or the wide
teacher's widths on the general body (`ar_sample(..., body="generic")`)
instead of the built one.  It prints beside the card's name and power
limit:

* us per step at batch 8 x 5,376 steps (CUDA events, one call each, in
  turns, twice) of the kernel as it is, of the phase-counter build and,
  of copies with one choice changed (teacher_lj's widths: a 3-stage
  weight ring in place of 4, bf16; the wide teacher's: at most 6 ring
  stages in place of 16, chunks of 8,192 weights in place of 4,096, the
  producer polling its barriers in place of try_wait, 8 blocks a cluster
  in place of 16, and two diagnostics whose samples are not the kernel's:
  the products removed, a quarter of each chunk streamed; on the general
  route four diagnostics, `CHANGED["generic"]`, and batch 1 at --widths
  generic);
* the clock cycles per step in each phase, from a build with
  PWN_AR_SAMPLER_PHASES: one thread of block 0 (rank 0 of the first
  cluster; thread 0, or at the wide widths lane 0 of the warp that sums the
  rank's columns) adds them up.  The counting slows the kernel (its us per step is printed
  too), so these are shares, not times;
* with --before DIR, an earlier tree's kernel (DIR holds its csrc/, as
  `git archive <commit> pwn_tpu_torch/csrc | tar -x -C DIR` writes it),
  timed in the same turns and split by phase the same way, on the
  weights' "slices" layout (on the general route: the tree's one-block
  general body, `pwn_ar_sample_generic` of trees before the cluster body,
  whose markers this tool inserts into its copy, `BEFORE_PHASES`); at
  teacher_lj's widths, and on the general route, the two trees' built
  bodies are also run on the same seeded inputs (teacher_lj, clarinet_gaussian and tiny_teacher
  on "slices", the wide teacher on "chunks", bf16 and fp32 weights, B = 3
  x T = 1,003), and the tool exits non-zero unless they give the same
  bits;
* a check build with PWN_AR_SAMPLER_CHECK, in which every rank of every
  cluster writes its samples to an (N, B, T) buffer: at batch 8 x 1,003
  steps the tool asserts that all N ranks agree bit for bit, and with
  wav, and exits non-zero if they do not.

Run from the repository root:

    python3 tools/torch_ar_sampler_phases.py [--widths wide|generic] \
        [--body generic] [--weights fp32] [--before DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch import cli, get_config  # noqa: E402
from pwn_tpu_torch.models import sampling  # noqa: E402
from pwn_tpu_torch.models.teacher import init_teacher  # noqa: E402
from pwn_tpu_torch.ops import _build  # noqa: E402
from pwn_tpu_torch.ops.ar_sampler import (AR_GEN_RANKS,  # noqa: E402
                                          ar_block_launch_args,
                                          ar_generic_launch_args,
                                          ar_launch_args, ar_ranks,
                                          check_ar_args,
                                          stack_teacher_weights)
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402

SOURCE = _build.CSRC / "ar_sampler.cu"
# (text in the source, its replacement) for each copy with one choice changed
CHANGED = {"teacher_lj": {"3-stage ring": [
    ("STAGES = sizeof(W) == 2 ? 4 : 2;", "STAGES = sizeof(W) == 2 ? 3 : 2;")]},
    "wide": {"6-stage ring": [("WIDE_STAGES = 16;", "WIDE_STAGES = 6;")],
             "8192-weight chunks": [("WIDE_CHUNK_E = 4096;", "WIDE_CHUNK_E = 8192;")],
             "polling producer": [("if (!first) mbar_wait(", "if (!first) mbar_spin(")],
             "8 ranks": [("WIDE_RANKS = 16;", "WIDE_RANKS = 8;")],
             # diagnostics (their samples are not the kernel's): the
             # products' loads and FMAs removed, the chunks still streamed
             # and waited for; or a quarter of each chunk streamed
             "no products": [("      if (gv * VW < kc) {", "      if (false) {"),
                             ("      if ((o + LG * v) * VW < g.kc) {", "      if (false) {"),
                             ("gq < NV; ++gq", "gq < 0; ++gq")],
             "a quarter streamed": [("chunk_at<D>(j, off, bytes);",
                                     "chunk_at<D>(j, off, bytes);\n            bytes /= 4;")]}}
# the general body's copies, all diagnostics whose samples are not the
# kernel's: each removes one piece of a layer (the gated unit's libm calls,
# the gate products' loads and FMAs, the queue writes and tap copies, the
# out products), so that its time beside the kernel's is that piece's share
CHANGED["generic"] = {
    "no libm gates": [("z[j] = tanhf(av) * (1.f / (1.f + expf(-bv)));", "z[j] = av * bv;")],
    "no gate loads and FMAs": [("    for (int v = lane; v < nv; v += 32) {",
                                "    for (int v = lane; v < 0; v += 32) {")],
    "no queue writes or tap copies": [
        ("        for (int n = tid; n < C; n += GEN_CT) {\n          if (store && n >= q0",
         "        for (int n = tid; n < 0; n += GEN_CT) {\n          if (store && n >= q0"),
        ("        if (pl.taps && d > 1) {\n          const float* rq",
         "        if (false) {\n          const float* rq")],
    "no out products": [("      for (; r + 4 <= rr; r += 4) {", "      for (; r + 4 <= 0; r += 4) {"),
                        ("      for (; r < rr; ++r) a0 = fmaf(", "      for (; r < 0; ++r) a0 = fmaf(")]}
# a copy's chunk size or blocks per cluster (the packing must match them)
LAUNCH = {"8192-weight chunks": {"chunk_elems": 8192}, "8 ranks": {"n_ranks": 8}}
WIDE_OVERRIDES = ["teacher.residual_channels=256", "teacher.gate_channels=512",
                  "teacher.skip_channels=256"]
GENERIC_OVERRIDES = ["teacher.residual_channels=96", "teacher.gate_channels=192",
                     "teacher.skip_channels=96"]
WIDE_FRONT = 0.3  # chip_smoke.py's WIDE_AR_FRONT: the wide random-init loop is chaotic
# The one-block general body (an earlier tree's `ar_generic_kernel`)
# has no phase markers: these substitutions put the ring kernel's
# counters into the before-copy's step (the tap's queue read and write and
# the residual sum as "x update", W_in's product and the gates as "x
# product and gates", W_out's as "out product", the head and the draw)
BEFORE_PHASES = [
    ("  if (tid == 0) *x_prev = 0.f;\n  __syncthreads();\n",
     "  if (tid == 0) *x_prev = 0.f;\n  __syncthreads();\n"
     "#ifdef PWN_AR_SAMPLER_PHASES\n"
     "  const bool phase_on = blockIdx.x == 0 && tid == 0;\n"
     "  unsigned long long phase_acc[NPHASES + 1] = {};\n"
     "  long long phase_t = clock64();\n#endif\n"),
    ("    for (int s = tid; s < S; s += GEN_THREADS) skip[s] = 0.f;\n",
     "    for (int s = tid; s < S; s += GEN_THREADS) skip[s] = 0.f;\n    PHASE(0);\n"),
    ("      __syncthreads();\n      const float* bg = a.b_g + (size_t)l * G;\n",
     "      __syncthreads();\n      PHASE(3);\n      const float* bg = a.b_g + (size_t)l * G;\n"),
    ("KIN * G, part);\n      __syncthreads();\n",
     "KIN * G, part);\n      __syncthreads();\n      PHASE(4);\n"),
    ("z[j] = tanhf(ga) * (1.f / (1.f + expf(-gb)));\n      }\n      __syncthreads();\n",
     "z[j] = tanhf(ga) * (1.f / (1.f + expf(-gb)));\n      }\n      __syncthreads();\n"
     "      PHASE(4);\n"),
    ("GH * NO, part);\n      __syncthreads();\n",
     "GH * NO, part);\n      __syncthreads();\n      PHASE(5);\n"),
    ("skip[n - C] + o;\n      }\n      __syncthreads();\n",
     "skip[n - C] + o;\n      }\n      __syncthreads();\n      PHASE(3);\n"),
    ("        a.wav[(size_t)b * T + t] = xt;\n      }\n    }\n    __syncthreads();\n  }\n}\n",
     "        a.wav[(size_t)b * T + t] = xt;\n      }\n    }\n    __syncthreads();\n"
     "    PHASE(8);\n#ifdef PWN_AR_SAMPLER_PHASES\n    if (phase_on) ++phase_acc[NPHASES];\n"
     "#endif\n  }\n#ifdef PWN_AR_SAMPLER_PHASES\n  if (phase_on)\n"
     "    for (int k = 0; k <= NPHASES; ++k) atomicAdd(&ar_phase_cycles[k], phase_acc[k]);\n"
     "#endif\n}\n"),
]
PIN = 25.0   # chip_smoke.py's AR_PIN: the MoL mixture pinned to component 0
B, T, T_CHECK = 8, 5376, 1003


def build(name: str, defines=(), subs=(), source: Path = SOURCE) -> tuple:
    """Start compiling a copy of `source` (ar_sampler.cu), with `subs`
    applied and `defines` set, into a library of its own; returns the
    compiler's process and the library's path (the caller starts every
    build before it waits for any)."""
    text = source.read_text()
    for old, new in subs:  # every occurrence
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    stem = "ar_tool_" + name.replace(" ", "_").replace("-", "_")
    cu = _build.BUILD_DIR / f"{stem}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    out = cu.with_suffix(".so")
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(source.parent),
         "-shared", *[f"-D{d}" for d in defines], "-o", str(out), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def load(proc, out: Path, before: bool = False) -> ctypes.CDLL:
    """Wait for a build and load it; the general route's entry point takes
    the one-block body's arguments in an earlier tree (`before`)."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {out.name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    lib.ptxas = log
    lib.pwn_ar_sample.argtypes = _build.AR_SAMPLE_ARGTYPES
    lib.pwn_ar_sample.restype = ctypes.c_int
    lib.pwn_ar_sample_generic.argtypes = (
        _build.AR_BLOCK_ARGTYPES if before else _build.AR_GENERIC_ARGTYPES)
    lib.pwn_ar_sample_generic.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", choices=("teacher_lj", "wide", "generic"),
                    default="teacher_lj")
    ap.add_argument("--body", choices=("built", "generic"), default="built",
                    help="run teacher_lj's or the wide teacher's widths on "
                         "the general body (--widths generic always does)")
    ap.add_argument("--weights", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--before", type=Path, default=None,
                    help="a directory holding an earlier tree's csrc/ (from "
                         "`git archive <commit> pwn_tpu_torch/csrc`): its "
                         "kernel is timed and split by phase beside this "
                         "one's, on the weights' \"slices\" layout")
    args = ap.parse_args()
    wdt = torch.bfloat16 if args.weights == "bf16" else torch.float32
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.widths == "generic" or args.body == "generic":
        return main_generic(args, wdt, device, smi)
    changed = CHANGED[args.widths]
    jobs = {"kernel": build("kernel"),
            "phase counters": build("phase counters", ("PWN_AR_SAMPLER_PHASES",)),
            "check": build("check", ("PWN_AR_SAMPLER_CHECK",))}
    jobs.update({k: build(k, subs=subs) for k, subs in changed.items()})
    if args.before:
        src = next(args.before.rglob("ar_sampler.cu"))
        jobs["before"] = build("before", source=src)
        jobs["before phase counters"] = build(
            "before phase counters", ("PWN_AR_SAMPLER_PHASES",), source=src)
    libs = {k: load(*job) for k, job in jobs.items()}
    layouts = {k: "slices" if k.startswith("before") else None for k in libs}
    # the earlier tree's kernel: 8 blocks a cluster at every width
    launch_kw = {k: {"n_ranks": 8} if k.startswith("before") else LAUNCH.get(k, {})
                 for k in libs}

    cfg = (cli._load_config("teacher_lj", WIDE_OVERRIDES)
           if args.widths == "wide" else get_config("teacher_lj"))
    tc = cfg.teacher
    model = init_teacher(cfg, torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        model.stack.head2.bias[0] += PIN
    weights = stack_teacher_weights(model.stack, wdt)
    n_ranks = ar_ranks(*(tc.residual_channels, tc.gate_channels,
                         tc.skip_channels, cfg.dsp.n_mels))
    kw = dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures, head=tc.output,
              log_scale_min=tc.log_scale_min, temperature=1.0)
    gen = torch.Generator(device=device).manual_seed(3)

    def inputs(steps):
        cond = torch.randn((B, steps, cfg.dsp.n_mels), generator=gen,
                           device=device) * 0.5
        return cond.bfloat16(), sampling.draw_noise(cfg, gen, steps, B)

    stream = torch.cuda.current_stream().cuda_stream

    def run(name, cond, noise, wav_ranks=None):
        check_ar_args(cond, noise, weights, kw["dilations"], kw["n_mixtures"],
                      kw["head"])
        args, held = ar_launch_args(cond, noise, weights, wav_ranks=wav_ranks,
                                    layout=layouts[name],
                                    **launch_kw[name], **kw)
        err = libs[name].pwn_ar_sample(*args, stream)
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
    timed = ("kernel", "phase counters", *changed,
             *(("before", "before phase counters") if args.before else ()))
    with torch.inference_mode():
        for k in timed:
            run(k, cond, noise)  # warm up
        torch.cuda.synchronize()
        ms = {k: [] for k in timed}
        for k in timed + timed[::-1] + timed + timed[::-1]:  # in turns, on one card
            ms[k].append(time_ms(lambda: run(k, cond, noise)))
        for k in timed:
            print(f"{smi}: kernel 4 {args.widths} {args.weights} weights "
                  f"B={B} T={T} (N={launch_kw[k].get('n_ranks', n_ranks)}), "
                  f"{k}: "
                  + " / ".join(f"{v:.3f}" for v in ms[k]) + " ms per call, "
                  + " / ".join(f"{v * 1e3 / T:.3f}" for v in ms[k])
                  + " us per step", flush=True)

        for k in (k for k in timed if k.endswith("phase counters")):
            counters = libs[k]
            counters.pwn_ar_sampler_phase_names.restype = ctypes.c_char_p
            names = counters.pwn_ar_sampler_phase_names().decode().split(";")
            cycles = (ctypes.c_ulonglong * (len(names) + 1))()
            counters.pwn_ar_sampler_phases(cycles)  # clear
            run(k, cond, noise)
            torch.cuda.synchronize()
            counters.pwn_ar_sampler_phases(cycles)
            steps = max(cycles[len(names)], 1)
            per_step = [cycles[i] / steps for i in range(len(names))]
            total = sum(per_step)
            print(f"{smi}: kernel 4 {args.widths} {args.weights} weights, "
                  f"{k}, cycles per step (one thread of block 0, {steps} "
                  f"steps, {total:.0f} a step, {total / tc.n_layers:.0f} a "
                  f"layer): " + ", ".join(f"{n} {c:.0f} ({c / total:.3f})"
                                          for n, c in zip(names, per_step)),
                  flush=True)

        cond, noise = inputs(T_CHECK)
        wav_ranks = torch.full((n_ranks, B, T_CHECK), float("nan"),
                               device=device)
        wav = run("check", cond, noise, wav_ranks)
        torch.cuda.synchronize()
    same = [torch.equal(wav_ranks[r], wav_ranks[0]) for r in range(n_ranks)]
    print(f"{smi}: check build {args.widths} {args.weights} weights B={B} "
          f"T={T_CHECK}: ranks equal to rank 0 bit "
          f"for bit {same}; rank 0 equal to wav {torch.equal(wav_ranks[0], wav)}; "
          f"{float((wav.abs() < 1).float().mean()):.3f} of the draws inside "
          f"(-1, 1)", flush=True)
    if not (all(same) and torch.equal(wav_ranks[0], wav)):
        print("the ranks of a cluster disagree", file=sys.stderr)
        return 1
    if args.before and args.widths == "teacher_lj" and not compare_trees(
            libs, device, smi):
        print("teacher_lj's or the tiny teacher's instantiation changed its "
              "bits", file=sys.stderr)
        return 1
    return 0


def sass_sizes(lib: Path, smi: str) -> None:
    """The instructions of each of kernel 4's functions in a build (from
    cuobjdump's SASS, where the toolkit has it): a body whose code passes
    the SM's instruction caches refetches it every step."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    sizes, name = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            sizes[name] = 0
        elif name and ln.strip().startswith("/*") and "*/" in ln[6:]:
            sizes[name] += 1
    for name, n in sizes.items():
        if "ar_" in name:
            print(f"{smi}: SASS of {name[-90:]}: {n} instructions "
                  f"({16 * n:,} B)", flush=True)


def main_generic(args, wdt, device, smi: str) -> int:
    """The general route: the cluster body (and, with --before, the earlier
    tree's one-block general body) timed in turns and split by phase, the check
    build's ranks held equal, and with --before the built bodies' bits held
    to the earlier tree's."""
    changed = CHANGED["generic"]
    jobs = {"kernel": build("kernel"),
            "phase counters": build("phase counters", ("PWN_AR_SAMPLER_PHASES",)),
            "check": build("check", ("PWN_AR_SAMPLER_CHECK",))}
    jobs.update({k: build(k, subs=subs) for k, subs in changed.items()})
    if args.before:
        src = next(args.before.rglob("ar_sampler.cu"))
        jobs["before"] = build("before", source=src)
        jobs["before phase counters"] = build(
            "before phase counters", ("PWN_AR_SAMPLER_PHASES",), BEFORE_PHASES,
            source=src)
    libs = {k: load(*job, before=k.startswith("before")) for k, job in jobs.items()}
    report = [ln.strip() for ln in libs["kernel"].ptxas.splitlines()]
    i = next((n for n, ln in enumerate(report) if "ar_generic_kernel" in ln), None)
    if i is not None:
        print(f"ptxas: {' | '.join(report[i:i + 4])}", flush=True)
    sass_sizes(jobs["kernel"][1], smi)

    overrides = {"generic": GENERIC_OVERRIDES, "wide": WIDE_OVERRIDES}
    cfg = (cli._load_config("teacher_lj", overrides[args.widths])
           if args.widths in overrides else get_config("teacher_lj"))
    tc = cfg.teacher
    model = init_teacher(cfg, torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        if args.widths == "wide":
            model.stack.front.kernel.mul_(WIDE_FRONT)
        model.stack.head2.bias[0] += PIN
    weights = stack_teacher_weights(model.stack, wdt)
    kw = dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures, head=tc.output,
              log_scale_min=tc.log_scale_min, temperature=1.0)
    batch = 1 if args.widths == "generic" else B  # the CLI path's batch
    gen = torch.Generator(device=device).manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream

    def inputs(rows, steps):
        cond = torch.randn((rows, steps, cfg.dsp.n_mels), generator=gen,
                           device=device) * 0.5
        return cond.bfloat16(), sampling.draw_noise(cfg, gen, steps, rows)

    def run(name, cond, noise, wav_ranks=None):
        check_ar_args(cond, noise, weights, kw["dilations"], kw["n_mixtures"],
                      kw["head"], "generic")
        if name.startswith("before"):
            a, held = ar_block_launch_args(cond, noise, weights, **kw)
        else:
            a, held = ar_generic_launch_args(cond, noise, weights, **kw,
                                             wav_ranks=wav_ranks)
        err = libs[name].pwn_ar_sample_generic(*a, stream)
        if err:
            raise RuntimeError(f"kernel 4's general body ({name}): launch failed ({err})")
        return held[0]

    def time_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    what = f"kernel 4 general body, {args.widths} widths, {args.weights} weights"
    cond, noise = inputs(batch, T)
    timed = ("kernel", "phase counters", *changed,
             *(("before", "before phase counters") if args.before else ()))
    with torch.inference_mode():
        for k in timed:
            run(k, cond, noise)  # warm up
        torch.cuda.synchronize()
        ms = {k: [] for k in timed}
        for k in timed + timed[::-1]:  # in turns, on one card
            ms[k].append(time_ms(lambda: run(k, cond, noise)))
        for k in timed:
            print(f"{smi}: {what} B={batch} T={T}, {k}: "
                  + " / ".join(f"{v:.3f}" for v in ms[k]) + " ms per call, "
                  + " / ".join(f"{v * 1e3 / T:.3f}" for v in ms[k])
                  + " us per step", flush=True)
        for k in (k for k in timed if k.endswith("phase counters")):
            counters = libs[k]
            counters.pwn_ar_sampler_phase_names.restype = ctypes.c_char_p
            names = counters.pwn_ar_sampler_phase_names().decode().split(";")
            cycles = (ctypes.c_ulonglong * (len(names) + 1))()
            counters.pwn_ar_sampler_phases(cycles)  # clear
            run(k, cond, noise)
            torch.cuda.synchronize()
            counters.pwn_ar_sampler_phases(cycles)
            steps = max(cycles[len(names)], 1)
            per_step = [cycles[i] / steps for i in range(len(names))]
            total = sum(per_step)
            print(f"{smi}: {what}, {k}, cycles per step (thread 0 of block 0, "
                  f"{steps} steps, {total:.0f} a step, {total / tc.n_layers:.0f} "
                  f"a layer): " + ", ".join(f"{n} {c:.0f} ({c / total:.3f})"
                                            for n, c in zip(names, per_step)),
                  flush=True)
        cond, noise = inputs(B, T_CHECK)
        wav_ranks = torch.full((AR_GEN_RANKS, B, T_CHECK), float("nan"),
                               device=device)
        wav = run("check", cond, noise, wav_ranks)
        torch.cuda.synchronize()
    same = [torch.equal(wav_ranks[r], wav_ranks[0]) for r in range(AR_GEN_RANKS)]
    print(f"{smi}: check build, {what}, B={B} T={T_CHECK}: ranks equal to "
          f"rank 0 bit for bit {same}; rank 0 equal to wav "
          f"{torch.equal(wav_ranks[0], wav)}; "
          f"{float((wav.abs() < 1).float().mean()):.3f} of the draws inside "
          f"(-1, 1)", flush=True)
    if not (all(same) and torch.equal(wav_ranks[0], wav)):
        print("the ranks of a cluster disagree", file=sys.stderr)
        return 1
    if args.before and not compare_trees(libs, device, smi):
        print("a built body changed its bits", file=sys.stderr)
        return 1
    return 0


def compare_trees(libs: dict, device, smi: str) -> bool:
    """The built bodies as they are against the earlier tree's (`before`)
    on the same seeded inputs: teacher_lj (MoL pinned), clarinet_gaussian
    and tiny_teacher ("slices") and the wide teacher ("chunks"), bf16 and
    fp32 weights, B = 3 x T = 1,003; True if every case gives the same
    bits."""
    stream = torch.cuda.current_stream().cuda_stream
    same_all = True
    for name in ("teacher_lj", "clarinet_gaussian", "tiny_teacher", "wide"):
        cfg = (cli._load_config("teacher_lj", WIDE_OVERRIDES) if name == "wide"
               else get_config(name))
        tc = cfg.teacher
        model = init_teacher(cfg, torch.Generator().manual_seed(1),
                             device=device)
        if tc.output == "mol":
            with torch.no_grad():
                model.stack.head2.bias[0] += PIN
        kw = dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures,
                  head=tc.output, log_scale_min=tc.log_scale_min,
                  temperature=1.0)
        for wdt in (torch.bfloat16, torch.float32):
            weights = stack_teacher_weights(model.stack, wdt)
            gen = torch.Generator(device=device).manual_seed(4)
            cond = (torch.randn((3, T_CHECK, cfg.dsp.n_mels), generator=gen,
                                device=device) * 0.5).to(
                torch.bfloat16 if tc.compute_dtype == "bfloat16"
                else torch.float32)
            noise = sampling.draw_noise(cfg, gen, T_CHECK, 3)
            out = {}
            with torch.inference_mode():
                for k in ("kernel", "before"):
                    check_ar_args(cond, noise, weights, kw["dilations"],
                                  kw["n_mixtures"], kw["head"])
                    args, held = ar_launch_args(cond, noise, weights, **kw)
                    if libs[k].pwn_ar_sample(*args, stream):
                        raise RuntimeError(f"kernel 4 ({k}): launch failed")
                    torch.cuda.synchronize()
                    out[k] = held[0].clone()
            same = torch.equal(out["kernel"], out["before"])
            same_all &= same
            print(f"{smi}: {name} ({tc.output}), weights {wdt}, B=3 "
                  f"T={T_CHECK}: this tree's kernel and the earlier tree's "
                  f"{'the same bits' if same else 'DIFFER'} (max abs diff "
                  f"{float((out['kernel'] - out['before']).abs().max()):.3e})",
                  flush=True)
    return same_all


if __name__ == "__main__":
    sys.exit(main())
