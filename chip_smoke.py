#!/usr/bin/env python3
"""Drive the PyTorch port's student IAF synthesis once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing what it finds:
  1. device  — the card, its power limit, the torch / CUDA / nvcc versions;
  2. build   — compile the CUDA kernels from `pwn_tpu_torch/csrc/`;
  3. kernel  — the flow-stack kernel against its plain PyTorch version on
               the card, per batch row, at the bench shape and edge shapes;
  4. main    — `student_iaf` at full width through `vocode_many` and
               `generate_student`, with the kernel's launch count;
  5. times   — kernel and plain ms per stack call, end-to-end
               audio-seconds per second at batch 8 x 2 s.
Any failure raises and the script exits non-zero.  Only when every phase
passed does it print, as its last line, {"ok": true, "device": {...}}.
The script imports no JAX; the machine with the card need not have it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pwn_tpu_torch import get_config, override
from pwn_tpu_torch.generate import (generate_student, mel_from_wav,
                                    vocode_many)
from pwn_tpu_torch.models.student import (StudentIAF, init_student,
                                          sample_base_noise)
from pwn_tpu_torch.ops import _build
from pwn_tpu_torch.ops.flow_stack import flow_stack, flow_stack_reference
from pwn_tpu_torch.utils.platform import require_cuda

SEED = 0
CFG = get_config("student_iaf")
BATCH, SECONDS = 8, 2.0  # the headline workload: batch 8 x 2 s at 22.05 kHz
# Kernel (bf16) vs the plain version in fp32, max|diff| / max|ref| per batch
# row.  The fp32 plain version rounds nothing; the kernel rounds x and z to
# bf16 every layer (2^-9 relative each), which over 10 layers gave the TPU kernel
# ~0.005 against its fp32 reference.  0.02 is 4x that and still far below
# the O(1) error of a wrong tap, a short halo or a leak between rows.
TOL_F32 = 0.02
WHY_F32 = ("bf16 rounding of x and z every layer; the TPU kernel sat at "
           "~0.005 against its fp32 reference")
# Kernel vs the plain version run in bf16, which rounds at the same points.
# Only fp32 summation order and tanh/exp ulps differ, but a flipped bf16
# rounding of x in an early layer carries through the later ones, so this
# gap is as large as the fp32 one (0.003-0.007 per row, first H100 run):
# the same bound holds.
TOL_BF16 = TOL_F32
# End-to-end, 4 flows of 10 layers in bf16 on the card vs the same model and
# z in fp32 on the CPU: relative L2 error.  The port's own bf16 plain path is
# 0.021 from fp32 on a 0.25 s clip (student_iaf, seed 0, CPU), the gap bf16
# rounding alone leaves; 0.05 allows 2.5x that.
TOL_E2E = 0.05
WHY_E2E = ("bf16 rounding through 40 layers; the bf16 plain path is 0.021 "
           "from fp32 on the CPU")
EDGE_SHAPES = [(1, 1000), (3, 5003), (2, 300), (5, 129), (1, 1)]


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _row_rel(out: torch.Tensor, ref: torch.Tensor) -> np.ndarray:
    B = out.shape[0]
    err = (out.float() - ref.float()).abs().reshape(B, -1).amax(1)
    scale = ref.float().abs().reshape(B, -1).amax(1) + 1e-6
    return (err / scale).cpu().numpy()


def _stack_inputs(B: int, T: int, device, seed: int):
    """Random stack operands at student widths in `flow_stack`'s layout
    (weights stored (out, in)), in the distribution of the reference's
    on-TPU kernel check (unit-variance pre-activations)."""
    sc = CFG.student
    L, C, G, S, M = (sc.layers_per_flow, sc.residual_channels,
                     sc.gate_channels, sc.skip_channels, CFG.dsp.n_mels)
    gen = torch.Generator(device=device).manual_seed(seed)

    def arr(shape, scale, dt):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dt)

    bf = torch.bfloat16
    return dict(
        x0=arr((B, T, C), 0.5, bf), cond=arr((B, T, M), 0.5, bf),
        w_in=arr((L, G, 2 * C + M), (2 * C + M) ** -0.5, bf),
        b_g=arr((L, G), 0.1, bf).float(),
        w_out=arr((L, C + S, G // 2), (G // 2) ** -0.5, bf),
        b_rs=arr((L, C + S), 0.1, bf).float(),
    )


def phase_device() -> tuple[torch.device, str]:
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(smi)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60)
    _log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}; "
         f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return device, smi


def phase_build() -> None:
    t = time.perf_counter()
    lib = _build.load_library()
    _log(f"[build] {_build.library_path().name} in "
         f"{time.perf_counter() - t:.1f} s; tile rows "
         f"{lib.pwn_flow_stack_tile_rows()}")
    log = _build.library_path().with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            _log(f"[build] ptxas: {line.strip()}")


def phase_kernel(device) -> dict:
    dil = CFG.student.flow_dilations
    before = flow_stack.launches
    calls = 0
    result = {}
    for k, (B, T) in enumerate([(BATCH, _bench_T())] + EDGE_SHAPES):
        args = _stack_inputs(B, T, device, seed=100 + k)
        with torch.inference_mode():
            out = flow_stack(**args, dilations=dil)
            calls += 1
            ref32 = flow_stack_reference(
                *(a.float() for a in args.values()), dilations=dil)
            ref16 = flow_stack_reference(**args, dilations=dil)
        torch.cuda.synchronize()
        _check(out.shape == (B, T, CFG.student.skip_channels),
               f"kernel output shape {tuple(out.shape)}")
        _check(torch.isfinite(out.float()).all(), "non-finite kernel output")
        rel32, rel16 = _row_rel(out, ref32), _row_rel(out, ref16)
        _log(f"[kernel] B={B} T={T}: per-row rel err vs fp32 plain "
             f"{np.array2string(rel32, precision=5)} (tol {TOL_F32}); "
             f"vs bf16 plain {np.array2string(rel16, precision=5)} "
             f"(tol {TOL_BF16}: {WHY_F32})")
        _check((rel32 <= TOL_F32).all(), f"kernel off fp32 plain at B={B} T={T}")
        _check((rel16 <= TOL_BF16).all(), f"kernel off bf16 plain at B={B} T={T}")
        if k == 0:
            result["max_abs_err"] = float(
                (out.float() - ref32.float()).abs().max())
    # rows are independent: perturbing row 1 leaves row 0 bit-identical
    args = _stack_inputs(2, 3000, device, seed=7)
    with torch.inference_mode():
        a = flow_stack(**args, dilations=dil)
        args["x0"] = args["x0"].clone()
        args["x0"][1] += 3.0
        b = flow_stack(**args, dilations=dil)
    calls += 2
    _check(torch.equal(a[0], b[0]), "row 1 leaked into row 0")
    _check(not torch.equal(a[1], b[1]), "perturbing row 1 changed nothing")
    _check(flow_stack.launches - before == calls,
           "launch counter did not count every call")
    _log(f"[kernel] batch rows isolated; {calls} launches counted")
    return result


def _bench_T() -> int:
    hop = CFG.dsp.hop_length
    return int(SECONDS * CFG.dsp.sample_rate) // hop * hop


def _synthetic_wavs(durations):
    sr = CFG.dsp.sample_rate
    rng = np.random.default_rng(SEED)
    wavs = []
    for sec in durations:
        t = np.arange(int(sec * sr)) / sr
        f0 = rng.uniform(100, 250)
        w = sum(0.3 / h * np.sin(2 * np.pi * h * f0 * t) for h in range(1, 6))
        w = w * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t))
        wavs.append((w + 0.01 * rng.standard_normal(t.size)).astype(np.float32))
    return wavs


def phase_main(device) -> dict:
    hop = CFG.dsp.hop_length
    model = init_student(CFG, torch.Generator().manual_seed(SEED), device)
    model.eval()
    wavs = _synthetic_wavs([1.0, 1.6, 2.3, 3.1, 4.0])
    mels = [mel_from_wav(CFG, w, device)[0].cpu().numpy() for w in wavs]
    bucket, batch = 64, 8
    buckets: dict = {}
    for m in mels:
        fb = -(-m.shape[0] // bucket) * bucket
        buckets[fb] = buckets.get(fb, 0) + 1
    n_batches = sum(-(-n // batch) for n in buckets.values())
    _check(len(buckets) >= 2 and any(n % batch for n in buckets.values()),
           "the utterances must span two buckets and a ragged batch")

    flow_stack.launches = 0
    outs = vocode_many(CFG, model, mels, seed=SEED, batch_size=batch,
                       bucket_frames=bucket)
    one = generate_student(CFG, model, mels[0][None],
                           torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    launches = flow_stack.launches
    n_flows = CFG.student.n_flows
    _log(f"[main] vocode_many: {len(mels)} items in {len(buckets)} buckets, "
         f"{n_batches} device batches; generate_student: 1 batch; "
         f"flow_stack launches {launches}")
    _check(launches == n_flows * (n_batches + 1),
           f"expected {n_flows * (n_batches + 1)} kernel launches")

    coef = CFG.dsp.preemphasis
    for m, w in zip(mels + [mels[0]], outs + [one]):
        _check(w.shape == (m.shape[0] * hop,), f"length {w.shape} for {m.shape}")
        _check(np.isfinite(w).all(), "non-finite audio")
        # undo the deemphasis: the flows' own output is clipped to [-1, 1]
        pre = w.astype(np.float64) - coef * np.concatenate([[0.0], w[:-1]])
        _check(np.abs(pre).max() <= 1.0 + 1e-4,
               f"pre-deemphasis peak {np.abs(pre).max()}")
    _log(f"[main] lengths {[w.shape[0] for w in outs]} + {one.shape[0]}; "
         "all finite; pre-deemphasis within [-1, 1]")

    # the kernel path against the same model and z in fp32 on the CPU
    mel = torch.from_numpy(mels[0])[None]
    z = sample_base_noise(CFG, torch.Generator().manual_seed(2),
                          (1, mel.shape[1] * hop))
    cpu_model = StudentIAF(override(CFG, "student.compute_dtype", "float32"))
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with torch.inference_mode():
        w_gpu = model.generate_from_z(z.to(device), mel.to(device)).cpu()
        w_cpu = cpu_model.generate_from_z(z, mel)
    rel = float((w_gpu - w_cpu).norm() / w_cpu.norm())
    _log(f"[main] 1 s utterance, card bf16 kernel path vs CPU fp32: rel L2 "
         f"{rel:.5f}, max abs {float((w_gpu - w_cpu).abs().max()):.5f} "
         f"(tol rel L2 {TOL_E2E}: {WHY_E2E})")
    _check(rel <= TOL_E2E, "kernel path off the fp32 CPU path")
    return {"launches": launches}


def _time_ms(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_times(device, smi: str) -> dict:
    dil = CFG.student.flow_dilations
    T = _bench_T()
    args = _stack_inputs(BATCH, T, device, seed=3)
    kernel = lambda: flow_stack(**args, dilations=dil)  # noqa: E731
    plain = lambda: flow_stack_reference(**args, dilations=dil)  # noqa: E731
    with torch.inference_mode():
        kernel(), plain()
        torch.cuda.synchronize()
        counted = flow_stack.launches
        p1 = _time_ms(plain, 5)
        k1 = _time_ms(kernel, 20)
        k2 = _time_ms(kernel, 20)
        p2 = _time_ms(plain, 5)
        flow_stack.launches = counted  # timing launches are not the main path's
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    flop = 2 * BATCH * T * len(dil) * ((2 * 64 + 80) * 128 + 64 * 128)
    _log(f"[times] {smi}: flow stack B={BATCH} T={T}: kernel {k1:.3f} / "
         f"{k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms per call "
         f"(kernel {flop / k_ms / 1e9:.1f} TFLOP/s useful)")

    model = init_student(CFG, torch.Generator().manual_seed(SEED), device)
    model.eval()
    frames = T // CFG.dsp.hop_length
    mel = torch.rand((BATCH, frames, CFG.dsp.n_mels),
                     generator=torch.Generator(device=device).manual_seed(0),
                     device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.inference_mode():
        for _ in range(2):
            model.generate(gen, mel)
        torch.cuda.synchronize()
        before = flow_stack.launches
        ms = _time_ms(lambda: model.generate(gen, mel), 10)
        flow_stack.launches = before
    audio_s = BATCH * T / CFG.dsp.sample_rate
    rate = audio_s / (ms / 1e3)
    _log(f"[times] {smi}: generate batch {BATCH} x {SECONDS} s: {ms:.3f} ms "
         f"per call, {rate:.1f} audio-seconds/s")
    return {"ms": k_ms, "plain_ms": p_ms}


def main() -> int:
    device, smi = phase_device()
    phase_build()
    kern = phase_kernel(device)
    main_path = phase_main(device)
    times = phase_times(device, smi)
    print(json.dumps({"kernels": [{
        "name": "flow_stack", "route": "cuda",
        "source": "pwn_tpu_torch/csrc/flow_stack.cu",
        "replaces": "pwn_tpu/ops/pallas/flow_stack.py:87",
        "launches": main_path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": times["ms"], "plain_ms": times["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
