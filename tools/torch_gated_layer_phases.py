#!/usr/bin/env python3
"""Where a tile's time goes inside kernel 5 (`csrc/gated_layer.cu`).

Builds the kernel alone with PWN_GATED_LAYER_PHASES, which makes thread 0
of block 0 add up the clock cycles of each phase of each of its tiles, then
runs each epilogue at the bench shapes of both widths (batch 8 x 2 s: T =
47,872 at C=128, 44,032 at C=64) on one CUDA card and prints, beside the
card's name and power limit, each case's ms per call (CUDA events over 20
calls; the counters add a few per cent) and its cycles per tile: waiting
for the activations, the gate product, the gates and z, the out product,
the epilogue.  Run from the repository root:

    python3 tools/torch_gated_layer_phases.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch.ops import _build  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402

SOURCE = _build._PKG / "csrc" / "gated_layer.cu"
PHASES = ("activations", "gate product", "gates and z", "out product",
          "epilogue")


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "gated_layer_phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                    "-DPWN_GATED_LAYER_PHASES", "-o", str(out), str(SOURCE)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pwn_gated_layer_bf16.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.pwn_gated_layer_acc_bf16.argtypes = [p] * 9 + [i] * 9 + [p]
    lib.pwn_gated_layer_phases.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    return lib


def main() -> int:
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lib = build()
    cycles = (ctypes.c_ulonglong * 6)()
    stream = torch.cuda.current_stream().cuda_stream
    for (C, G, S, M), T in (((128, 256, 128, 80), 47872),
                            ((64, 128, 64, 80), 44032)):
        B = 8
        gen = torch.Generator(device=device).manual_seed(0)

        def arr(shape, scale):
            return torch.randn(shape, generator=gen, device=device) * scale

        x, cond = arr((B, T, C), 0.5).bfloat16(), arr((B, T, M), 0.5).bfloat16()
        w_in = arr((G, 2 * C + M), (2 * C + M) ** -0.5).bfloat16()
        w_out = arr((C + S, G // 2), (G // 2) ** -0.5).bfloat16()
        b_g, b_out = arr((G,), 0.1), arr((C + S,), 0.1)
        res = torch.empty_like(x)
        skip = torch.empty((B, T, S), dtype=torch.bfloat16, device=device)
        acc = torch.zeros((B, T, S), device=device)
        ops = [t.data_ptr() for t in (x, cond, w_in, b_g, w_out, b_out)]

        def layer():
            return lib.pwn_gated_layer_bf16(*ops, res.data_ptr(),
                                            skip.data_ptr(), B, T, C, G, S, M,
                                            512, stream)

        def accumulate(first, last):
            return lambda: lib.pwn_gated_layer_acc_bf16(
                *ops, None if last else res.data_ptr(), acc.data_ptr(),
                skip.data_ptr() if last else None, B, T, C, G, S, M, 512,
                int(first), int(last), stream)

        cases = {"layer": layer, "accumulate first": accumulate(True, False),
                 "accumulate middle": accumulate(False, False),
                 "accumulate last": accumulate(False, True)}
        for name, fn in cases.items():
            if fn():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            lib.pwn_gated_layer_phases(cycles)  # clear
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            torch.cuda.synchronize()
            lib.pwn_gated_layer_phases(cycles)
            tiles = max(cycles[5], 1)
            per_tile = [cycles[k] / tiles for k in range(5)]
            total = sum(per_tile)
            print(f"{smi}: kernel 5 {name}, (C, G, S, M) = {(C, G, S, M)}, "
                  f"B={B} T={T}: {start.elapsed_time(end) / 20:.4f} ms per "
                  f"call; cycles per tile (block 0, {tiles // 20} tiles a "
                  f"call): " + ", ".join(
                      f"{p} {c:.0f} ({c / total:.2f})"
                      for p, c in zip(PHASES, per_tile)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
