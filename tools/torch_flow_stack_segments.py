#!/usr/bin/env python3
"""Time the flow-stack CUDA kernel at several segment lengths.

Each kernel block owns one (batch row, time segment) and first recomputes
a sum(d)-sample halo, so the segment length trades halo work against the
number of blocks and waves.  At `student_iaf` widths and batch 8 x 2 s
this prints, beside the card's name and power limit, one row per segment:
blocks, executed / useful rows, and ms per call (CUDA events, mean of
--iters calls after one warm-up), marking the wrapper's default.  Every
output must be bit-identical to the default's.  Run from the repository
root on a CUDA card:

    python3 tools/torch_flow_stack_segments.py [--iters 20]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch import get_config  # noqa: E402
from pwn_tpu_torch.ops import _build  # noqa: E402
from pwn_tpu_torch.ops.flow_stack import flow_stack, segment_length  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402

SEGMENTS = (1024, 1408, 2048, 3712, 4096, 5632, 11008, 44032)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = get_config("student_iaf")
    sc = cfg.student
    L, C, G, S, M = (sc.layers_per_flow, sc.residual_channels,
                     sc.gate_channels, sc.skip_channels, cfg.dsp.n_mels)
    dil = sc.flow_dilations
    hop, B = cfg.dsp.hop_length, 8
    T = int(2.0 * cfg.dsp.sample_rate) // hop * hop
    gen = torch.Generator(device=device).manual_seed(3)

    def arr(shape, scale, dt=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dt)

    ops = dict(x0=arr((B, T, C), 0.5), cond=arr((B, T, M), 0.5),
               w_in=arr((L, G, 2 * C + M), (2 * C + M) ** -0.5),
               b_g=arr((L, G), 0.1).float(),
               w_out=arr((L, C + S, G // 2), (G // 2) ** -0.5),
               b_rs=arr((L, C + S), 0.1).float())
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    default = segment_length(B, T, n_sm,
                             _build.load_library().pwn_flow_stack_tile_rows())
    halo = sum(dil)

    def run(seg):
        return flow_stack(**ops, dilations=dil, segment=seg)

    with torch.inference_mode():
        want = run(default)
        print(f"{smi}: flow_stack B={B} T={T} at student_iaf widths, "
              f"{n_sm} SMs, halo {halo}, mean of {args.iters} calls")
        print("segment | blocks | executed / useful rows | ms")
        for seg in sorted(set(SEGMENTS) | {default}):
            run(seg)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                out = run(seg)
            end.record()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"segment {seg} changed the output")
            n_seg = -(-T // seg)
            executed = sum(min(T, (i + 1) * seg) - max(0, i * seg - halo)
                           for i in range(n_seg))
            mark = " (default)" if seg == default else ""
            print(f"{seg}{mark} | {B * n_seg} | {executed / T:.3f} | "
                  f"{start.elapsed_time(end) / args.iters:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
