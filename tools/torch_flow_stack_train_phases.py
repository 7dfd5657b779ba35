#!/usr/bin/env python3
"""Where a tile's time goes inside kernel 3's layer pass
(`csrc/flow_stack_train.cu::train_bwd_layer`).

Builds the kernel's source alone four more times, all nvcc processes
started together: with PWN_FLOW_STACK_TRAIN_PHASES, which makes thread 0
of block 0 add up the clock cycles of each phase of each of its tiles, and
with one phase's work taken out (PWN_FST_NO_GATES: the gates as plain
values; PWN_FST_NO_DX: no dx loads; PWN_FST_NO_EPILOGUE: no dpart, dcs,
dcond or z stores; the results of those three are wrong and only timed).
Then, on one CUDA card at teacher_lj's shape (24 layers, batch 8 x 16,384,
random bf16 operands from seed 0), it prints beside the card's name and
power limit:
  * the cycles per tile by phase, in both backward modes: dx in and the
    dskip wait, the dz product, the activations wait, the gate products,
    the gates and dg, the dcx and dcs products and their epilogues, the
    dcc product and its epilogue (the counters add a few per cent);
  * the ms per backward of the package's own build and of each build with
    a phase taken out, in turns (own, cut, cut, own; CUDA events over 5
    calls), and the ms that taking the phase out saves.
Run from the repository root:

    python3 tools/torch_flow_stack_train_phases.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch import get_config  # noqa: E402
from pwn_tpu_torch.ops import _build  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402

SOURCE = _build._PKG / "csrc" / "flow_stack_train.cu"
PHASES = ("dx in", "dz product", "activations wait", "gate products",
          "gates and dg", "dcx and dcs products + epilogues",
          "dcc product + epilogue")
BUILDS = {"phases": "-DPWN_FLOW_STACK_TRAIN_PHASES",
          "no gates": "-DPWN_FST_NO_GATES",
          "no dx loads": "-DPWN_FST_NO_DX",
          "no epilogue stores": "-DPWN_FST_NO_EPILOGUE"}


def build() -> dict:
    """One shared library per entry of BUILDS, compiled in parallel."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {k: _build.BUILD_DIR / f"flow_stack_train_{k.replace(' ', '_')}.so"
            for k in BUILDS}
    procs = {k: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", flag, "-o",
         str(outs[k]), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, flag in BUILDS.items()}
    main = _build.load_library()
    libs = {}
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {k}:\n{log}")
        lib = ctypes.CDLL(str(outs[k]))
        for fn in ("pwn_flow_stack_train_bwd_bf16",
                   "pwn_flow_stack_train_bwd_workspace_bytes"):
            getattr(lib, fn).argtypes = getattr(main, fn).argtypes
            getattr(lib, fn).restype = getattr(main, fn).restype
        libs[k] = lib
    libs["phases"].pwn_flow_stack_train_phases.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong)]
    libs["own"] = main
    return libs


def main() -> int:
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    libs = build()
    cfg = get_config("teacher_lj")
    tc = cfg.teacher
    L, C, G, S, M = (tc.n_layers, tc.residual_channels, tc.gate_channels,
                     tc.skip_channels, cfg.dsp.n_mels)
    dil = tc.dilations
    B, T = 8, 16384
    gen = torch.Generator(device=device).manual_seed(0)

    def arr(shape, scale, dt=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dt)

    acts, cond = arr((L, B, T, C), 0.5), arr((B, T, M), 0.5)
    w_in = arr((L, G, 2 * C + M), (2 * C + M) ** -0.5)
    w_out = arr((L, C + S, G // 2), (G // 2) ** -0.5)
    b_g, dskip = arr((L, G), 0.1, torch.float32), arr((B, T, S), 1.0)
    dx = torch.empty((B, T, C), dtype=torch.bfloat16, device=device)
    dcond = torch.empty((B, T, M), dtype=torch.bfloat16, device=device)
    grads = [torch.empty(s, device=device) for s in
             ((L, G, 2 * C + M), (L, G), (L, C + S, G // 2), (L, C + S))]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    ws = torch.empty(libs["own"].pwn_flow_stack_train_bwd_workspace_bytes(
        B, T, C, G, S, M, 1, n_sm), dtype=torch.uint8, device=device)
    dil_c = (ctypes.c_int * L)(*dil)

    def call(lib, want):
        ptrs = [g.data_ptr() for g in grads] if want else [None] * 4
        err = lib.pwn_flow_stack_train_bwd_bf16(
            acts.data_ptr(), cond.data_ptr(), dskip.data_ptr(), w_in.data_ptr(),
            b_g.data_ptr(), w_out.data_ptr(), dx.data_ptr(), dcond.data_ptr(),
            *ptrs, ws.data_ptr(), B, T, L, C, G, S, M, dil_c, int(want), n_sm,
            stream)
        if err:
            raise RuntimeError(f"kernel 3 failed with CUDA error {err}")

    def time_ms(lib, want, n=5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call(lib, want)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    cycles = (ctypes.c_ulonglong * 8)()
    for want in (False, True):
        call(libs["phases"], want)
        torch.cuda.synchronize()
        libs["phases"].pwn_flow_stack_train_phases(cycles)  # clear
        ms = time_ms(libs["phases"], want)
        libs["phases"].pwn_flow_stack_train_phases(cycles)
        tiles = max(cycles[7], 1)
        per_tile = [cycles[k] / tiles for k in range(7)]
        total = sum(per_tile)
        print(f"{smi}: kernel 3 layer pass, want_wgrads={want}, B={B} T={T}, "
              f"{L} layers: {ms:.3f} ms per backward under the counters; "
              f"cycles per tile (block 0, {tiles // (5 * L)} tiles a layer): "
              + ", ".join(f"{p} {c:.0f} ({c / total:.2f})"
                          for p, c in zip(PHASES, per_tile)), flush=True)
    for name in ("no gates", "no dx loads", "no epilogue stores"):
        for want in (False, True):
            for lib in (libs["own"], libs[name]):
                call(lib, want)
            torch.cuda.synchronize()
            t = {"own": [], name: []}
            for k in ("own", name, name, "own"):
                t[k].append(time_ms(libs[k], want))
            own, cut = float(np.mean(t["own"])), float(np.mean(t[name]))
            print(f"{smi}: kernel 3 want_wgrads={want} B={B} T={T}: own build "
                  + " / ".join(f"{v:.3f}" for v in t["own"]) + f" ms, {name} "
                  + " / ".join(f"{v:.3f}" for v in t[name])
                  + f" ms: {own - cut:.3f} ms saved ({(own - cut) / own:.1%})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
