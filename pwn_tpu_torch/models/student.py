"""Student IAF: parallel mel-conditioned waveform synthesis (counterpart of
`pwn_tpu/models/student.py`).

z ~ Logistic(0,1)^T is pushed through n_flows affine inverse-autoregressive
flows, each a causal WaveNet over the previous z shifted right by one:

    z_i[t] = z_{i-1}[t] * s_i(z_{i-1}[<t], c) + mu_i(z_{i-1}[<t], c)

so the whole waveform comes out of one parallel pass.  The base noise is
Logistic(0, 1) (Parallel WaveNet) or, with `student.base="gaussian"`,
N(0, 1) (ClariNet).  `transform` also returns the closed-form density
log p_S(x) = log p_base(z_0) - sum_i log s_i (`StudentOutput.
log_p_student`) that distillation needs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models.modules import (DTYPES, UpsampleNet, WaveNetStack,
                                          match_length, resolve_stack_mode)
from pwn_tpu_torch.ops import gaussian, mol
from pwn_tpu_torch.ops.conv import shift_right
from pwn_tpu_torch.utils.platform import require_cuda

BASES = ("logistic", "gaussian")


def _check_base(cfg: Config) -> None:
    if cfg.student.base not in BASES:
        raise ValueError(f"unknown student base {cfg.student.base!r}; one of "
                         f"{BASES}")


def sample_base_noise(cfg: Config, generator: torch.Generator,
                      shape) -> torch.Tensor:
    """Base noise per `student.base` on the generator's device:
    Logistic(0, 1), or N(0, 1) for "gaussian"."""
    _check_base(cfg)
    if cfg.student.base == "gaussian":
        return gaussian.sample_normal(generator, shape)
    return mol.sample_logistic(generator, shape)


class StudentOutput(NamedTuple):
    wav: torch.Tensor         # (B, T) synthesized waveform
    log_det: torch.Tensor     # (B, T) sum_i log s_i[t]
    log_p_base: torch.Tensor  # (B, T) base log-density of z_0
    mu_last: torch.Tensor     # (B, T) final flow's mu
    # (B, T) total affine offset: x = exp(log_det) * z0 + mu_total, so the
    # per-step output conditional is base(mu_total, exp(log_det))
    mu_total: torch.Tensor

    @property
    def log_p_student(self) -> torch.Tensor:
        """(B, T) closed-form student log-density at its own sample:
        log p_base(z0) - sum log s."""
        return self.log_p_base - self.log_det


class StudentIAF(nn.Module):
    """`stack_mode` is every flow's WaveNetStack mode ("infer", "layer",
    "train" or "dx"); by default it follows `student.fused_layers`, whose
    "auto" means "infer" here.  The training loops ask for "train".  A
    flow with a dilation above TIME_TILE builds "layer" whatever is asked
    (`resolve_stack_mode`)."""

    def __init__(self, config: Config, stack_mode: str | None = None,
                 device=None):
        super().__init__()
        _check_base(config)
        sc, tc = config.student, config.teacher
        if sc.kernel_size != 2:
            raise NotImplementedError("WaveNetStack uses kernel_size=2")
        self.config = config
        dtype = DTYPES[sc.compute_dtype]
        self.upsample = UpsampleNet(
            strides=tc.upsample_strides, channels=config.dsp.n_mels,
            in_channels=config.dsp.n_mels,
            kernel_mult=tc.upsample_kernel_mult, dtype=dtype,
            weight_norm=tc.upsample_weight_norm, device=device,
        )
        for i in range(sc.n_flows):
            self.add_module(f"flow_{i}", WaveNetStack(
                dilations=sc.flow_dilations,
                residual_channels=sc.residual_channels,
                gate_channels=sc.gate_channels,
                skip_channels=sc.skip_channels, out_dim=2,
                cond_channels=config.dsp.n_mels, dtype=dtype,
                mode=resolve_stack_mode(stack_mode or sc.fused_layers,
                                        "infer", sc.flow_dilations),
                device=device,
            ))

    @property
    def flows(self) -> list:
        return [getattr(self, f"flow_{i}")
                for i in range(self.config.student.n_flows)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.upsample.reset_parameters(generator)
        for flow in self.flows:
            flow.reset_parameters(generator)

    def forward(self, z: torch.Tensor, mel: torch.Tensor) -> StudentOutput:
        """Transform base noise z (B, T) under mel conditioning (B, F, M)."""
        cond = match_length(self.upsample(mel), z.shape[-1])
        return self.transform(z, cond)

    def transform(self, z: torch.Tensor, cond: torch.Tensor) -> StudentOutput:
        clamp = self.config.student.log_scale_clamp
        z = z.float()
        zeros = torch.zeros_like(z)
        log_p_base = (gaussian.gaussian_log_density
                      if self.config.student.base == "gaussian"
                      else mol.logistic_log_density)(z, zeros, zeros)
        log_det = torch.zeros_like(z)
        mu = torch.zeros_like(z)
        mu_total = torch.zeros_like(z)
        for flow in self.flows:
            # strictly causal input: the flow at t sees z[<t] only
            out = flow(shift_right(z[..., None], 1), cond)  # (B, T, 2) fp32
            mu = out[..., 0]
            log_s = torch.clamp(out[..., 1], -clamp, clamp)
            z = z * torch.exp(log_s) + mu
            mu_total = mu_total * torch.exp(log_s) + mu
            log_det = log_det + log_s
        return StudentOutput(wav=torch.clamp(z, -1.0, 1.0), log_det=log_det,
                             log_p_base=log_p_base, mu_last=mu,
                             mu_total=mu_total)

    def generate(self, generator: torch.Generator, mel: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
        """Sample a waveform (B, F*hop) in one parallel pass."""
        hop = self.config.dsp.hop_length
        B, F = mel.shape[0], mel.shape[1]
        z = sample_base_noise(self.config, generator, (B, F * hop))
        return self.generate_from_z(z * temperature, mel)

    def generate_from_z(self, z: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        """Synthesis from caller-provided base noise z (B, T)."""
        cond = match_length(self.upsample(mel), z.shape[-1])
        return self.flows_from_z(z, cond)

    def upsample_cond(self, mel: torch.Tensor) -> torch.Tensor:
        """The conditioning upsampler alone: (B, F, M) -> (B, F*hop, M)."""
        return self.upsample(mel)

    def flows_from_z(self, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The flow chain on (z, sample-rate cond); the tail of every
        generate path."""
        clamp = self.config.student.log_scale_clamp
        z = z.float()
        for flow in self.flows:
            out = flow(shift_right(z[..., None], 1), cond)
            log_s = torch.clamp(out[..., 1], -clamp, clamp)
            z = z * torch.exp(log_s) + out[..., 0]
        return torch.clamp(z, -1.0, 1.0)


def init_student(config: Config, generator: torch.Generator, device=None,
                 *, stack_mode: str | None = None) -> StudentIAF:
    """A student with flax's initialisation scheme: truncated-normal fan-in
    kernels and zero biases, drawn from `generator` (same shapes as
    `pwn_tpu.models.student.init_student`, not the same numbers).  The
    draw happens on the generator's device, then the model moves to
    `device` (default: the CUDA card; the CPU only when passed
    explicitly), so one seed gives one model wherever it runs.
    `stack_mode` as `StudentIAF`'s."""
    model = StudentIAF(config, stack_mode=stack_mode,
                       device=generator.device)
    model.reset_parameters(generator)
    return model.to(require_cuda() if device is None else device)
