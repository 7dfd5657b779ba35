"""Benchmark suite of the port (counterpart of `pwn_tpu/benchmarks.py`):
the primary metric is student IAF synthesis in audio-seconds per second
per card; the detail adds teacher, distillation and direct training
steps, teacher AR sampling and `large_student_sharded` synthesis.

    python -m pwn_tpu_torch.cli bench [case] [key=value ...]

prints `run_bench`'s result as one JSON line.

Method:

* every timed region ends in `_force`, the `.item()` of a device checksum
  that depends on all of the work, which also synchronises with the card;
* a chain is a Python loop of n calls whose checksums add up on the
  device, closed by one `_force`; it is timed at n and at 2n and the
  per-iteration time is the difference over n (two-point differencing),
  so the fixed cost of the sync cancels, while the host's launch work of
  every call stays in, as it does in a user's call;
* a difference that is not above 1.5x the measured sync round trip is
  retried with n doubled and, failing that, reported as `timing_error`
  with zeroed rates: never clamped;
* every rate is checked against the analytic FLOP floor of the card's
  data-sheet peak (`_plausibility_check`), and an MFU above 1 is an error.

The measurements build the port's models at full width with random
weights from seeded `torch.Generator`s and run on the card (`device=`
passes the CPU, as the tests do).  `kernel_canary` holds every kernel
against its fp32 plain version per batch row on the card.  The
data-parallel audit and the scaling table run in processes of their own
(`_run_ranks`, one per rank, this module's `__main__`).
"""

from __future__ import annotations

import base64
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pwn_tpu_torch.config import Config, get_config, override
from pwn_tpu_torch.data.pipeline import SyntheticTones, make_train_iterator
from pwn_tpu_torch.models import sampling
from pwn_tpu_torch.models.modules import resolve_stack_mode
from pwn_tpu_torch.models.student import init_student
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.ops import flow_stack as fs
from pwn_tpu_torch.ops.ar_sampler import ar_sample
from pwn_tpu_torch.ops.gated_layer import gated_layer
from pwn_tpu_torch.parallel.mesh import (broadcast_int, ensure_distributed,
                                         process_count, process_index)
from pwn_tpu_torch.training.common import (average_across_processes,
                                           create_train_state, global_norm,
                                           step_generator)
from pwn_tpu_torch.training.teacher import (make_teacher_train_step,
                                            prepare_batch)
from pwn_tpu_torch.utils.platform import configure_precision, require_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device(device) -> torch.device:
    """The CUDA card unless `device` names another device."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda":
        configure_precision()
    return device


def _force(x) -> float:
    """Synchronise by reading a scalar checksum back to the host."""
    return float(torch.as_tensor(x).item())


def measure_round_trip_ms(reps: int = 7, device=None) -> float:
    """Median latency of the sync that closes a chain: a trivial sum on
    the device read back by `_force`."""
    x = torch.ones((8, 8), device=_device(device))
    _force(x.sum())
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _force(x.sum())
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples)) * 1e3


def _time_chain(
    chain_fn: Callable[[int], Any],
    n_iters: int,
    reps: int = 3,
    max_doublings: int = 3,
    device=None,
    agree: Optional[Callable[[bool], bool]] = None,
) -> Tuple[Optional[float], Dict[str, Any]]:
    """Best per-iteration seconds of a chain.

    `chain_fn(n)` runs n iterations as a Python loop of calls whose device
    checksums add up, and returns that device scalar.  The chain is timed
    at n and 2n, `reps` times, alternating; per-iteration time = (t_2n -
    t_n) / n.  That difference cancels the fixed cost of the closing sync
    only: the host's launch work of each call is part of every iteration,
    as it is of a user's call.

    The difference must exceed 1.5x the round trip measured beside it
    (`measure_round_trip_ms` on `device`), else n doubles, up to
    `max_doublings` times; a measurement still not separable returns
    (None, meta with `timing_error`), never a clamped or negative number.
    `agree(ok)` makes that decision the same in every process of a group
    (each rank's chain joins collectives, so all must time alike).
    """
    _force(chain_fn(1))  # warm-up: kernels built, caches filled
    meta: Dict[str, Any] = {}
    for _ in range(max_doublings + 1):
        rtt_ms = measure_round_trip_ms(device=device)
        t1 = t2 = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _force(chain_fn(n_iters))
            t1 = min(t1, time.perf_counter() - t0)
            t0 = time.perf_counter()
            _force(chain_fn(2 * n_iters))
            t2 = min(t2, time.perf_counter() - t0)
        diff = t2 - t1
        meta = {
            "n_iters": n_iters,
            "rtt_ms": round(rtt_ms, 3),
            "chain_1x_ms": round(t1 * 1e3, 3),
            "chain_2x_ms": round(t2 * 1e3, 3),
            "method": "two-point differencing (the sync's cost cancels)",
        }
        ok = diff > 1.5 * rtt_ms / 1e3
        if agree is not None:
            ok = agree(ok)
        if ok:
            return diff / n_iters, meta
        n_iters *= 2
    meta["timing_error"] = (
        "chain timing not separable from the sync's noise: "
        f"t(2n)-t(n) = {diff * 1e3:.3f} ms <= 1.5x round trip "
        f"({rtt_ms:.3f} ms) after {max_doublings} doublings "
        f"(largest chain timed: n={n_iters // 2}, 2n={n_iters}); "
        "refusing to report a rate"
    )
    return None, meta


def _rate_result(dt: Optional[float], meta: Dict[str, Any],
                 fields: Dict[str, Callable[[float], float]],
                 extra: Dict[str, Any]) -> Dict[str, Any]:
    """Assemble a measurement dict; zero the rates on timing failure."""
    out: Dict[str, Any] = dict(extra)
    if dt is None:
        for k in fields:
            out[k] = 0.0
        out["step_ms"] = 0.0
        out["error"] = meta.get("timing_error", "timing failed")
    else:
        for k, fn in fields.items():
            out[k] = fn(dt)
        out["step_ms"] = dt * 1e3
    out["timing"] = meta
    return out


def _uniform_mel(cfg: Config, batch: int, frames: int, device) -> torch.Tensor:
    """The reference's bench mel: uniform [0, 1) from numpy seed 0."""
    return torch.from_numpy(
        np.random.default_rng(0)
        .uniform(0, 1, (batch, frames, cfg.dsp.n_mels))
        .astype(np.float32)).to(device)


def _train_batch(cfg: Config, batch: int, device) -> torch.Tensor:
    """The first batch (seed 0) of crops from an 8-clip tone corpus."""
    ds = SyntheticTones(8, cfg.train.crop_samples, cfg.dsp.sample_rate)
    return torch.from_numpy(next(make_train_iterator(ds, cfg, batch,
                                                     seed=0))).to(device)


def _loss_chain(step, state, wav, device) -> Callable[[int], torch.Tensor]:
    """n optimizer steps of `step` on one batch; the losses summed."""
    def chain(n):
        acc = torch.zeros((), device=device)
        for _ in range(n):
            _, metrics = step(state, wav)
            acc = acc + metrics["loss"]
        return acc

    return chain


def measure_student_inference(cfg: Config, batch: int = 8,
                              seconds: float = 2.0, n_iters: int = 8,
                              device=None) -> Dict[str, Any]:
    """Student parallel synthesis throughput: audio-seconds/s per card
    (`StudentIAF.generate`, one process on one card)."""
    device = _device(device)
    sr = cfg.dsp.sample_rate
    hop = cfg.dsp.hop_length
    frames = int(seconds * sr) // hop
    T = frames * hop
    model = init_student(cfg, torch.Generator().manual_seed(0), device).eval()
    mel = _uniform_mel(cfg, batch, frames, device)

    @torch.inference_mode()
    def chain(n):
        acc = torch.zeros((), device=device)
        for i in range(n):
            acc += model.generate(step_generator(1, i, device), mel).sum()
        return acc

    dt, meta = _time_chain(chain, n_iters, device=device)
    audio_sec = batch * T / sr
    return _rate_result(
        dt, meta,
        {
            "audio_sec_per_s_per_chip": lambda s: audio_sec / s,
            "samples_per_s": lambda s: batch * T / s,
        },
        {"batch": batch, "samples": T},
    )


def measure_teacher_train(cfg: Config, n_iters: int = 6,
                          device=None) -> Dict[str, Any]:
    """Teacher teacher-forcing training throughput: utterances/s, the
    training loop's step (`make_teacher_train_step`: loss, gradients,
    clipped Adam) in its stack mode ("auto": kernels 2 and 3)."""
    device = _device(device)
    model = init_teacher(
        cfg, torch.Generator().manual_seed(0),
        stack_mode=resolve_stack_mode(cfg.teacher.fused_layers, "train"),
        device=device)
    state = create_train_state(dict(model.named_parameters()), cfg.train)
    B = cfg.train.global_batch_size
    wav = _train_batch(cfg, B, device)
    dt, meta = _time_chain(
        _loss_chain(make_teacher_train_step(model, cfg), state, wav, device),
        n_iters, device=device)
    return _rate_result(
        dt, meta,
        {
            "teacher_utt_per_s": lambda s: B / s,
            "samples_per_s": lambda s: B * cfg.train.crop_samples / s,
        },
        {"batch": B, "crop_samples": cfg.train.crop_samples},
    )


def measure_distill_train(cfg: Config, n_iters: int = 4,
                          device=None) -> Dict[str, Any]:
    """Distillation step throughput: the student's forward and backward
    in mode "train" plus the frozen teacher's scoring in mode "dx" (kernel
    3 without weight gradients), as `run_distillation` builds them."""
    from pwn_tpu_torch.training.distill import make_distill_train_step
    from pwn_tpu_torch.training.loop import frozen_teacher

    device = _device(device)
    teacher = frozen_teacher(
        cfg, init_teacher(cfg, torch.Generator().manual_seed(0),
                          device=device).state_dict(), device)
    student = init_student(
        cfg, torch.Generator().manual_seed(1), device,
        stack_mode=resolve_stack_mode(cfg.student.fused_layers, "train"))
    state = create_train_state(dict(student.named_parameters()), cfg.train,
                               seed=2)
    B = cfg.train.global_batch_size
    wav = _train_batch(cfg, B, device)
    dt, meta = _time_chain(
        _loss_chain(make_distill_train_step(student, teacher, cfg), state,
                    wav, device),
        n_iters, device=device)
    return _rate_result(
        dt, meta,
        {"distill_utt_per_s": lambda s: B / s},
        {"batch": B, "crop_samples": cfg.train.crop_samples},
    )


def measure_student_direct_train(cfg: Config, n_iters: int = 4,
                                 device=None) -> Dict[str, Any]:
    """Direct (teacher-free) student training throughput: the IAF's
    closed-form NLL plus the power loss, the student in mode "train"."""
    from pwn_tpu_torch.training.student_direct import \
        make_student_direct_train_step

    device = _device(device)
    student = init_student(
        cfg, torch.Generator().manual_seed(1), device,
        stack_mode=resolve_stack_mode(cfg.student.fused_layers, "train"))
    state = create_train_state(dict(student.named_parameters()), cfg.train,
                               seed=2)
    B = cfg.train.global_batch_size
    wav = _train_batch(cfg, B, device)
    dt, meta = _time_chain(
        _loss_chain(make_student_direct_train_step(student, cfg), state,
                    wav, device),
        n_iters, device=device)
    return _rate_result(
        dt, meta,
        {"student_direct_utt_per_s": lambda s: B / s},
        {"batch": B, "crop_samples": cfg.train.crop_samples},
    )


def measure_teacher_ar_sampling(cfg: Config, batch: int = 8,
                                seconds: float = 0.25,
                                device=None) -> Dict[str, Any]:
    """Teacher AR sampling throughput: the whole-loop sampler
    (`fast_sample_kernel`, kernel 4) on the card, the eager conv-queue
    loop (`fast_sample`) on the CPU."""
    device = _device(device)
    sr = cfg.dsp.sample_rate
    hop = cfg.dsp.hop_length
    frames = max(int(seconds * sr) // hop, 2)
    T = frames * hop
    model = init_teacher(cfg, torch.Generator().manual_seed(0), device=device)
    mel = _uniform_mel(cfg, batch, frames, device)
    fn = (sampling.fast_sample if device.type == "cpu"
          else sampling.fast_sample_kernel)

    @torch.inference_mode()
    def chain(n):
        acc = torch.zeros((), device=device)
        for i in range(n):
            acc += fn(model, step_generator(1, i, device), mel).sum()
        return acc

    # 4 chained waveforms to start, the reference's depth; doubles if noisy
    dt, meta = _time_chain(chain, 4, device=device)
    return _rate_result(
        dt, meta,
        {
            "ar_samples_per_s": lambda s: batch * T / s,
            "ar_steps_per_s": lambda s: T / s,
            "ar_audio_sec_per_s": lambda s: batch * T / sr / s,
            "ar_us_per_step": lambda s: s / T * 1e6,
        },
        {"batch": batch, "samples": T},
    )


# ---------------------------------------------------------------------------
# On-card kernel canary
# ---------------------------------------------------------------------------

# thresholds of the reference's canary: healthy rows sit at the bf16
# accumulation level (~0.005 relative for the stacks, ~0.02-0.03 absolute
# over 512 AR feedback steps); a miscompiled row showed ~0.3 relative, O(1)
# absolute
GEN_THRESH, DX_THRESH, AR_THRESH = 0.08, 0.12, 0.15
AR_PIN = 25.0  # on the MoL head's component-0 logit bias


def _row_rel(out: torch.Tensor, ref: torch.Tensor) -> np.ndarray:
    """max|out - ref| / max|ref| per batch row."""
    B = ref.shape[0]
    err = (out.float() - ref.float()).abs().reshape(B, -1).amax(1)
    scale = ref.float().abs().reshape(B, -1).amax(1) + 1e-6
    return (err / scale).cpu().numpy()


def _canary_verdict(gen_rows, dx_rows, ar_rows,
                    layout: Dict[str, int]) -> Dict[str, Any]:
    """The canary's result from its per-row errors: pass only if every row
    of every check is under its threshold."""
    ok = bool(max(gen_rows) < GEN_THRESH and max(dx_rows) < DX_THRESH
              and max(ar_rows) < AR_THRESH)
    return {
        "pass": ok,
        "gen_row_rel_err": [round(float(v), 5) for v in gen_rows],
        "train_dx_row_rel_err": [round(float(v), 5) for v in dx_rows],
        "ar_row_abs_diff": [round(float(v), 5) for v in ar_rows],
        "thresholds": {"gen_rel": GEN_THRESH, "dx_rel": DX_THRESH,
                       "ar_abs": AR_THRESH},
        "layout": layout,
    }


def kernel_canary(cfg: Config, batch: int = 8, T: int = 2048,
                  device=None) -> Dict[str, Any]:
    """A short per-batch-row check of every kernel family on the card,
    run inside each bench, at the preset's student stack layout:

    * generation: `flow_stack` (kernel 1 where it takes the stack, else
      kernel 5's accumulate epilogue per layer) against the fp32 plain
      version, per row;
    * training: dx of `flow_stack_train` (kernels 2 and 3, weight
      gradients on) against autograd through the fp32 plain version, per
      row;
    * AR: kernel 4 (`fast_sample_kernel`) against the eager plain sampler
      on one shared noise stream, on the tiny fp32 teacher with the MoL
      choice pinned to component 0 (a random init's near-uniform logits
      would let any rounding flip a draw and part the trajectories).

    A miscompile corrupts specific rows by O(1) while the CPU's plain
    versions stay exact, so this runs on the card; on the CPU it returns
    `{"skipped": ...}`.
    """
    device = _device(device)
    if device.type == "cpu":
        return {"skipped": "cpu device (the plain versions run there; "
                           "the kernels run only on the card)"}
    return _canary_checks(cfg, batch, T, device)


def _canary_checks(cfg: Config, batch: int, T: int,
                   device: torch.device) -> Dict[str, Any]:
    """`kernel_canary`'s checks on `device`: on a CPU one the wrappers run
    their plain versions, which is how the tests rehearse them."""
    sc = cfg.student
    L, C, G, S = (sc.layers_per_flow, sc.residual_channels,
                  sc.gate_channels, sc.skip_channels)
    M = cfg.dsp.n_mels
    dil = tuple(sc.flow_dilations)
    dt = torch.bfloat16 if sc.compute_dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(42)

    def arr(shape, scale):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(device)

    # flow_stack's layout: weights stored (out, in), biases fp32
    x0 = arr((batch, T, C), 0.5).to(dt)
    cond = arr((batch, T, M), 0.5).to(dt)
    w_in = arr((L, G, 2 * C + M), (2 * C + M) ** -0.5).to(dt)
    b_g = arr((L, G), 0.1).to(dt).float()
    w_out = arr((L, C + S, G // 2), (G // 2) ** -0.5).to(dt)
    b_rs = arr((L, C + S), 0.1).to(dt).float()
    weights = (w_in, b_g, w_out, b_rs)

    x0f = x0.float().requires_grad_()
    ref_skip = fs.flow_stack_reference(x0f, cond.float(),
                                       *(w.float() for w in weights),
                                       dilations=dil)
    (ref_dx,) = torch.autograd.grad(ref_skip.sum(), x0f)
    with torch.no_grad():
        gen_skip = fs.flow_stack(x0, cond, *weights, dilations=dil)
    xk = x0.clone().requires_grad_()
    wk = [w.clone().requires_grad_() for w in weights]
    skip = fs.flow_stack_train(xk, cond, *wk, dilations=dil)
    train_dx = torch.autograd.grad(skip.float().sum(), [xk, *wk])[0]
    gen_rows = _row_rel(gen_skip, ref_skip.detach())
    dx_rows = _row_rel(train_dx, ref_dx)

    cfg_ar = get_config("tiny_teacher")
    if cfg.teacher.output != cfg_ar.teacher.output:
        cfg_ar = override(cfg_ar, "teacher.output", cfg.teacher.output)
    hop = cfg_ar.dsp.hop_length
    frames = max(512 // hop, 2)
    Tar = frames * hop
    model = init_teacher(cfg_ar, torch.Generator().manual_seed(0),
                         device=device)
    if cfg_ar.teacher.output == "mol":
        with torch.no_grad():
            model.stack.head2.bias[0] += AR_PIN
    mel = _uniform_mel(cfg_ar, batch, frames, device)
    noise = sampling.draw_noise(
        cfg_ar, torch.Generator(device=device).manual_seed(7), Tar, batch)
    plain = sampling.fast_sample(model, None, mel, noise=noise)
    kern = sampling.fast_sample_kernel(model, None, mel, noise=noise)
    ar_rows = (kern - plain).abs().amax(1).cpu().numpy()
    return _canary_verdict(gen_rows, dx_rows, ar_rows, {
        "L": L, "C": C, "G": G, "S": S, "B": batch, "T": T, "ar_steps": Tar})


# ---------------------------------------------------------------------------
# Analytic FLOPs model + MFU
# ---------------------------------------------------------------------------

# dense bf16 peak per card by device name (NVIDIA's data sheets; the SXM
# part at its 700 W limit)
_PEAK_BF16_TFLOPS = {"H100 80GB HBM3": 989.0, "H100 PCIe": 756.0}
H100_SXM_BF16_TFLOPS = _PEAK_BF16_TFLOPS["H100 80GB HBM3"]


def peak_bf16_tflops(device=None) -> float | None:
    """The card's data-sheet bf16 peak (default: the current card); None
    for a card not in the table, and for the CPU."""
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        return None
    name = torch.cuda.get_device_name(device)
    for key, val in _PEAK_BF16_TFLOPS.items():
        if key in name:
            return val
    return None


def _stack_macs_per_sample(C: int, G: int, S: int, M: int, L: int,
                           out_dim: int) -> float:
    """MACs per output timestep of one WaveNetStack: the front 1x1, L
    gated layers as two wide GEMMs, the relu/1x1/1x1 head."""
    return (C                               # front 1x1 (1 -> C)
            + L * ((2 * C + M) * G          # gate GEMM [x|shift|cond]@w_in
                   + (G // 2) * (C + S))    # out GEMM z@[w_res|w_skip]
            + S * S + S * out_dim)          # head1 + head2


def _upsample_macs_per_sample(cfg: Config) -> float:
    """Transposed-conv mel upsampler MACs amortized per OUTPUT sample."""
    M = cfg.dsp.n_mels
    strides = list(cfg.teacher.upsample_strides)
    mult = cfg.teacher.upsample_kernel_mult
    total = 0.0
    for i, s in enumerate(strides):
        after = 1
        for s2 in strides[i + 1:]:
            after *= s2
        total += (s * mult) * M * M / after
    return total


def student_gen_flops_per_sample(cfg: Config) -> float:
    """Forward FLOPs per generated audio sample (all flows + upsampler)."""
    sc = cfg.student
    macs = cfg.student.n_flows * _stack_macs_per_sample(
        sc.residual_channels, sc.gate_channels, sc.skip_channels,
        cfg.dsp.n_mels, sc.layers_per_flow, out_dim=2,
    ) + _upsample_macs_per_sample(cfg)
    return 2.0 * macs


def teacher_fwd_flops_per_sample(cfg: Config) -> float:
    tc = cfg.teacher
    macs = _stack_macs_per_sample(
        tc.residual_channels, tc.gate_channels, tc.skip_channels,
        cfg.dsp.n_mels, tc.n_layers, out_dim=tc.head_dim,
    ) + _upsample_macs_per_sample(cfg)
    return 2.0 * macs


def _plausibility_check(step_ms: float, flops_per_step: float,
                        peak_tflops: float | None) -> Optional[str]:
    """Physical-bounds gate: a step cannot beat the data-sheet peak.
    Returns an error string for an impossible number."""
    if step_ms <= 0.0:
        return f"non-positive step time ({step_ms} ms)"
    if peak_tflops is None:
        return None
    floor_ms = flops_per_step / (peak_tflops * 1e12) * 1e3
    if step_ms < floor_ms:
        return (f"step_ms {step_ms:.4f} below analytic FLOPs floor "
                f"{floor_ms:.4f} ms (would exceed {peak_tflops} TFLOP/s "
                "datasheet peak) — measurement invalid")
    return None


# Links of an HGX H100 node, NVIDIA's data sheets, not measured here:
NVLINK_BW = 4.5e11  # bytes/s per GPU per direction, NVLink 4, within 8 GPUs
NIC_BW = 5.0e10     # bytes/s per GPU, one 400 Gb/s NDR NIC, between nodes
GPUS_PER_NODE = 8


def analytic_dp_efficiency(cfg: Config, step_ms: float,
                           counts=(2, 4, 8, 16, 64, 256)) -> Any:
    """Predicted DP weak-scaling efficiency of the teacher step from a
    ring all-reduce roofline.

    Model: per step, the fp32 gradients ring-all-reduce 2·P·(n−1)/n bytes
    per card; efficiency = step / (step + comm), zero overlap assumed.
    Within a node the ring runs over NVLink; across nodes an intra-node
    reduce is followed by an inter-node ring in which each of a node's 8
    GPUs carries 1/8 of the gradient over its own NIC, so a node moves
    8 x NIC_BW.
    """
    if step_ms is None or step_ms <= 0.0:
        return {"error": "no valid step_ms to extrapolate from "
                         "(upstream timing failed)"}
    teacher = TeacherWaveNet(cfg, stack_mode="train", device="meta")
    p_bytes = sum(p.numel() for p in teacher.parameters()) * 4
    node_bw = GPUS_PER_NODE * NIC_BW
    rows = []
    for n in counts:
        hosts = max(1, n // GPUS_PER_NODE)
        if hosts == 1:
            comm_s = 2.0 * p_bytes * (n - 1) / n / NVLINK_BW
            link = "nvlink"
        else:
            comm_s = (2.0 * p_bytes * (GPUS_PER_NODE - 1) / GPUS_PER_NODE
                      / NVLINK_BW
                      + 2.0 * p_bytes * (hosts - 1) / hosts / node_bw)
            link = "nic"
        eff = (step_ms / 1e3) / ((step_ms / 1e3) + comm_s)
        rows.append({"devices": n, "hosts": hosts, "link": link,
                     "comm_ms": round(comm_s * 1e3, 3),
                     "predicted_efficiency": round(eff, 4)})
    return {"param_bytes": p_bytes, "step_ms": step_ms,
            "note": "ring all-reduce roofline, zero overlap assumed; "
                    "NVLink 4 (450 GB/s a direction) and NDR NIC (50 GB/s "
                    "a GPU) are data-sheet figures, not measured",
            "rows": rows}


def analytic_tp_efficiency(cfg: Config, n_model: int = 2,
                           per_chip_batch: int = 8) -> Dict[str, Any]:
    """Roofline of Megatron gate-channel TP training of this model family:
    per gated layer, the row-parallel z @ [w_res|w_skip] output needs one
    all-reduce of the (B, T, C+S) activation (and its mirror in the
    backward); compare that traffic over NVLink with the layer's compute.
    The model is activation-dominated, which is why the port trains data-
    parallel and shards only the state over the model axis."""
    T = cfg.train.crop_samples
    b = per_chip_batch
    peak = peak_bf16_tflops() or H100_SXM_BF16_TFLOPS

    def layer_row(C, G, S, M, n_layers, tag):
        # one layer: gate GEMM (2C+M)xG + out GEMM (G/2)x(C+S), fwd;
        # training ~3x fwd FLOPs.  TP splits compute n_model ways.
        flops = 2.0 * b * T * ((2 * C + M) * G + (G // 2) * (C + S))
        compute_ms = 3.0 * flops / n_model / (peak * 1e12) * 1e3
        # all-reduce payload: (b, T, C+S) bf16, fwd + the mirrored bwd
        # all-reduce of dz; ring cost 2*(n-1)/n per card
        payload = b * T * (C + S) * 2
        comm_ms = (2.0 * payload * 2.0 * (n_model - 1) / n_model
                   / NVLINK_BW * 1e3)
        return {
            "stack": tag, "layers": n_layers,
            "per_layer_compute_ms": round(compute_ms, 4),
            "per_layer_psum_ms": round(comm_ms, 4),
            "comm_over_compute": round(comm_ms / compute_ms, 2),
            "step_comm_ms": round(comm_ms * n_layers, 2),
        }

    sc, tc, M = cfg.student, cfg.teacher, cfg.dsp.n_mels
    rows = [
        layer_row(sc.residual_channels, sc.gate_channels,
                  sc.skip_channels, M,
                  sc.n_flows * sc.layers_per_flow, "student"),
        layer_row(tc.residual_channels, tc.gate_channels,
                  tc.skip_channels, M, tc.n_layers, "teacher(score)"),
    ]
    total_comm = sum(r["step_comm_ms"] for r in rows)
    total_compute = sum(
        r["per_layer_compute_ms"] * r["layers"] for r in rows
    )
    return {
        "n_model": n_model, "per_chip_batch": b, "crop_samples": T,
        "rows": rows,
        "distill_step_comm_ms": round(total_comm, 1),
        "distill_step_compute_ms": round(total_compute, 1),
        "predicted_tp_efficiency": round(
            total_compute / (total_compute + total_comm), 3
        ),
        "note": "Megatron gate-sharded TP training roofline, zero "
                "overlap, NVLink 4 data-sheet bandwidth (not measured); "
                "compare DP's one gradient all-reduce per step "
                "(analytic_dp_efficiency)",
    }


# ---------------------------------------------------------------------------
# Data parallelism: the equivalence audit and the scaling table, each run
# by one process per rank
# ---------------------------------------------------------------------------


def dp_equivalence_check(cfg: Config, device=None) -> Dict[str, Any]:
    """Pass/fail audit of the data-parallel step, called in every process
    of a group: each rank's gradients and loss on its rows of the batch,
    averaged across processes (`average_across_processes`), must equal one
    process's on the whole batch.  The teacher runs the reference's
    `fused_layers="off"` (mode "layer")."""
    cfg = override(cfg, "teacher.fused_layers", "off")
    device = _device(device)
    n, rank = process_count(), process_index()
    model = init_teacher(cfg, torch.Generator().manual_seed(0), device=device)
    params = list(model.parameters())
    B = max(cfg.train.global_batch_size, n)
    B -= B % n
    wav = _train_batch(cfg, B, device)

    def loss_grads(w):
        loss = model.loss(*prepare_batch(w, cfg))
        return loss.detach(), list(torch.autograd.grad(loss, params))

    ref_loss, ref_grads = loss_grads(wav)
    rows = B // n
    loss, grads = loss_grads(wav[rank * rows:(rank + 1) * rows])
    dp_grads, metrics = average_across_processes(grads, {"loss": loss})
    max_rel = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                  for a, b in zip(dp_grads, ref_grads))
    loss_rel = abs(float(metrics["loss"]) - float(ref_loss)) / (
        abs(float(ref_loss)) + 1e-12)
    # the per-process mean changes the fp32 reduction order, ~1e-4..1e-3
    # relative on the gradients
    ok = max_rel < 2e-3 and loss_rel < 1e-5
    return {"devices": n, "batch": B, "pass": bool(ok),
            "max_grad_rel_err": max_rel, "loss_rel_err": loss_rel,
            "note": "gradients averaged across processes vs one process's "
                    "gradients on the identical global batch"}


def _scaling_row(cfg: Config, n_iters: int, device=None) -> Dict[str, Any]:
    """One row of `measure_scaling`, called in every process of a group:
    the teacher step (mode "layer", gradients averaged across processes)
    at the 1-card batch per rank, timed in lockstep."""
    cfg = override(cfg, "teacher.fused_layers", "off")
    device = _device(device)
    n, rank = process_count(), process_index()
    model = init_teacher(cfg, torch.Generator().manual_seed(0), device=device)
    params = list(model.parameters())
    per_rank = cfg.train.global_batch_size
    B = per_rank * n  # weak scaling: ideal is a flat step_ms
    wav = _train_batch(cfg, B, device)[rank * per_rank:(rank + 1) * per_rank]
    x, mel = prepare_batch(wav, cfg)

    def chain(k):
        acc = torch.zeros((), device=device)
        for _ in range(k):
            loss = model.loss(x, mel)
            grads, m = average_across_processes(
                list(torch.autograd.grad(loss, params)),
                {"loss": loss.detach()})
            # the gradient norm keeps the backward in the checksum
            acc = acc + m["loss"] + global_norm(grads) * 1e-6
        return acc

    dt, meta = _time_chain(chain, n_iters, device=device,
                           agree=lambda ok: bool(broadcast_int(int(ok))))
    if dt is None:
        return {"devices": n, "batch": B, "error": meta.get("timing_error"),
                "timing": meta}
    return {"devices": n, "batch": B, "utt_per_s": B / dt,
            "step_ms": dt * 1e3, "timing": meta}


_RANK_TASKS = {"dp_equivalence": dp_equivalence_check,
               "scaling": _scaling_row}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(task: str, world: int, cfg: Config, *args, cpu: bool,
               timeout: float = 600.0) -> Dict[str, Any]:
    """Run `_RANK_TASKS[task](cfg, *args)` in `world` processes of one
    group (this module's `__main__`, with a launcher's environment: RANK,
    WORLD_SIZE, LOCAL_RANK, a free port on localhost), rank r on card r,
    or all on the CPU in a Gloo group with `cpu`; rank 0's result.  Every
    process is killed past `timeout` seconds or when one fails."""
    blob = base64.b64encode(pickle.dumps(cfg)).decode()
    port = str(_free_port())
    with tempfile.TemporaryDirectory(prefix="pwn_ranks_") as logs:
        procs, files = [], []
        try:
            for rank in range(world):
                env = {**os.environ, "RANK": str(rank),
                       "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                       "OMP_NUM_THREADS": "1"}
                if cpu:
                    env["CUDA_VISIBLE_DEVICES"] = ""
                log = open(os.path.join(logs, f"rank{rank}.log"), "w+")
                files.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "pwn_tpu_torch.benchmarks", task,
                     "cpu" if cpu else "cuda", blob, *map(str, args)],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if None not in codes or any(codes):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for log in files:
                log.seek(0)
                outs.append(log.read())
                log.close()
    if any(p.returncode for p in procs):  # killed past the deadline: -9
        raise RuntimeError(f"{task} over {world} processes failed: " + " | ".join(
            f"rank {r} exit {p.returncode}: {out[-1500:]}"
            for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode))
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{task}: rank 0 printed no result: {outs[0][-1500:]}")


def _dp_equivalence_cpu_sim() -> Any:
    """`dp_equivalence_check` over a Gloo group of 4 CPU processes on the
    tiny teacher (crop 1,024, batch 8): the audit where there is one
    card.  Its own failure is reported, never raised."""
    cfg = get_config("tiny_teacher", **{"train.crop_samples": 1024,
                                        "train.global_batch_size": 8})
    try:
        out = _run_ranks("dp_equivalence", 4, cfg, cpu=True)
    except Exception as e:  # never fail the bench over the sim audit
        return {"error": repr(e)}
    out["sim"] = "cpu-gloo-4proc-tiny"
    return out


def measure_scaling(cfg: Config, n_iters: int = 4) -> list:
    """DP weak-scaling table over 1, 2, 4 and 8 cards, as many as the
    machine has: each row one NCCL group of that many processes.
    Efficiency is relative to the 1-card row, and marked invalid if that
    row's timing failed."""
    counts = [n for n in (1, 2, 4, 8) if n <= torch.cuda.device_count()]
    rows = [_run_ranks("scaling", n, cfg, n_iters, cpu=False)
            for n in counts]
    valid = [r for r in rows if "utt_per_s" in r]
    # normalizing to the smallest surviving row would overstate every
    # efficiency (its own row reads 1.0)
    base_rows = [r for r in valid if r["devices"] == 1]
    if base_rows:
        base = base_rows[0]["utt_per_s"]
        for r in valid:
            r["efficiency"] = round((r["utt_per_s"] / r["devices"]) / base, 3)
    elif valid:
        for r in valid:
            r["efficiency"] = "invalid (1-device baseline failed)"
    return rows


# ---------------------------------------------------------------------------
# The suite
# ---------------------------------------------------------------------------


def _launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count so far in this process."""
    by = fs.flow_stack_train_backward.launches_by
    return {"kernel 1": fs.flow_stack.launches,
            "kernel 5": gated_layer.launches,
            "kernel 3": sum(v for k, v in by.items() if k[-1]),
            "kernel 3 dx-only": sum(v for k, v in by.items() if not k[-1]),
            "kernel 4": ar_sample.launches}


def _device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return str(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def run_bench(case: str = "student_iaf", overrides=None, full: bool = True,
              device=None) -> Dict[str, Any]:
    device = _device(device)
    counted = _launch_counts()
    cfg = get_config(case, **(overrides or {}))
    student = measure_student_inference(cfg, device=device)
    detail: Dict[str, Any] = {"student": student,
                              "device": _device_name(device)}
    errors = []
    peak = peak_bf16_tflops(device)
    mfu: Dict[str, Any] = {
        "peak_bf16_tflops": peak,
        "note": "analytic GEMM/conv FLOPs vs datasheet bf16 peak",
    }

    def check_student(tag: str, s_cfg: Config, res: Dict[str, Any]):
        """Plausibility-gate a student-inference result + record MFU."""
        if "error" in res:
            errors.append(f"{tag}: " + res["error"])
            return
        flops_step = (student_gen_flops_per_sample(s_cfg)
                      * res["batch"] * res["samples"])
        bad = _plausibility_check(res["step_ms"], flops_step, peak)
        if bad:
            res["error"] = bad
            errors.append(f"{tag}: " + bad)
            return
        rate = flops_step / (res["step_ms"] / 1e3)
        mfu[f"{tag}_tflops"] = round(rate / 1e12, 3)
        mfu[tag] = (round(rate / (peak * 1e12), 4) if peak else None)

    check_student("student_infer", cfg, student)
    # the kernel canary runs even when timing fails: it catches silent
    # corruption on its own
    detail["kernel_check"] = kernel_canary(cfg, device=device)
    if detail["kernel_check"].get("pass") is False:
        errors.append("kernel_check: per-row kernel validation FAILED "
                      "(a kernel disagrees with its plain version on some "
                      "rows — see detail)")
    if full:
        t_cfg = get_config("teacher_lj")
        detail["teacher_train"] = measure_teacher_train(t_cfg, device=device)
        detail["distill_train"] = measure_distill_train(
            get_config("student_iaf"), device=device)
        detail["student_direct_train"] = measure_student_direct_train(
            get_config("student_iaf"), device=device)
        detail["teacher_ar"] = measure_teacher_ar_sampling(t_cfg,
                                                           device=device)
        # the other shipped generation preset: C=128 flows on kernel 5's
        # accumulate epilogue, and the MFU-by-width comparison
        if case != "large_student_sharded":
            c4 = get_config("large_student_sharded")
            detail["student_config4"] = measure_student_inference(
                c4, device=device)
            check_student("student_infer_config4", c4,
                          detail["student_config4"])
        tt = detail["teacher_train"]
        if "error" not in tt:
            # train fwd+bwd ~= 3x forward FLOPs
            t_flops_step = (3.0 * teacher_fwd_flops_per_sample(t_cfg)
                            * tt["batch"] * tt["crop_samples"])
            bad = _plausibility_check(tt["step_ms"], t_flops_step, peak)
            if bad:
                tt["error"] = bad
                errors.append("teacher_train: " + bad)
            else:
                rate = t_flops_step / (tt["step_ms"] / 1e3)
                mfu["teacher_train_tflops"] = round(rate / 1e12, 3)
                mfu["teacher_train"] = (round(rate / (peak * 1e12), 4)
                                        if peak else None)
        n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if n_cards > 1:
            detail["dp_equivalence"] = _run_ranks(
                "dp_equivalence", n_cards, t_cfg, cpu=False)
            detail["dp_scaling"] = measure_scaling(t_cfg)
        else:
            detail["dp_equivalence"] = _dp_equivalence_cpu_sim()
        if detail["dp_equivalence"].get("pass") is False:
            errors.append("dp_equivalence: averaged grads != one process's")
        detail["dp_analytic"] = analytic_dp_efficiency(
            t_cfg, detail["teacher_train"]["step_ms"]
        )
    for k, v in list(mfu.items()):
        if isinstance(v, float) \
                and k.endswith(("_infer", "_train", "_config4")) \
                and v > 1.0:
            errors.append(f"mfu.{k} = {v} > 1.0 — physically impossible")
            mfu[k] = None
    detail["mfu"] = mfu
    now = _launch_counts()
    detail["launches"] = {k: now[k] - counted[k] for k in now}
    value = student["audio_sec_per_s_per_chip"] \
        if "error" not in student else 0.0
    out = {
        "metric": "student_audio_sec_per_s_per_chip",
        "value": round(value, 2),
        "unit": "audio-sec/s/chip (= x realtime)",
        # the reference's north-star target: >100x realtime per chip
        "vs_baseline": round(value / 100.0, 3),
        "detail": detail,
    }
    if errors:
        out["error"] = "; ".join(errors)
    return out


def _rank_main(task: str, device_kind: str, blob: str, *args) -> int:
    """One process of `_run_ranks`: join the group the environment
    describes, run the task, and print rank 0's result."""
    torch.set_num_threads(1)
    device = torch.device("cpu") if device_kind == "cpu" else require_cuda()
    ensure_distributed(device)
    cfg = pickle.loads(base64.b64decode(blob))  # written by _run_ranks
    result = _RANK_TASKS[task](cfg, *map(int, args), device=device)
    if process_index() == 0:
        print("RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(*sys.argv[1:]))
