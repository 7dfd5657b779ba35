"""Teacher WaveNet: the autoregressive mel-conditioned density model with a
discretized mixture-of-logistics head, or a single-Gaussian head with
`teacher.output="gaussian"` (counterpart of `pwn_tpu/models/teacher.py`).

Training is one teacher-forcing pass over all time steps at once: the
stack sees the waveform shifted right by one sample and predicts the head
parameters of every sample.  Sampling is sequential and lives in
`models/sampling.py`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models.modules import (DTYPES, UpsampleNet, WaveNetStack,
                                          match_length, resolve_stack_mode,
                                          shift_right_scalar)
from pwn_tpu_torch.ops import gaussian, mol
from pwn_tpu_torch.utils.platform import require_cuda


class TeacherWaveNet(nn.Module):
    """p(x_t | x_<t, mel).  `forward(wav, mel)` returns the per-step head
    parameters (B, T, head_dim: 3K for the MoL head, 2 for the Gaussian
    one); `condition(mel)` the upsampled conditioning.

    `stack_mode` is the WaveNetStack mode ("infer", "layer", "train" or
    "dx"); by default it follows `teacher.fused_layers`, whose "auto" means
    "infer" here, as it means the whole-stack inference kernel in the
    reference (kernel 1 or kernel 5's accumulate loop on the card).  The
    training loop asks for "train", the distillation loop "dx".  A stack
    with a dilation above TIME_TILE builds "layer" whatever is asked
    (`resolve_stack_mode`)."""

    def __init__(self, config: Config, stack_mode: str | None = None,
                 device=None):
        super().__init__()
        tc = config.teacher
        if tc.kernel_size != 2:
            raise NotImplementedError("WaveNetStack uses kernel_size=2")
        self.config = config
        dtype = DTYPES[tc.compute_dtype]
        n_mels = config.dsp.n_mels
        self.upsample = UpsampleNet(
            strides=tc.upsample_strides, channels=n_mels, in_channels=n_mels,
            kernel_mult=tc.upsample_kernel_mult, dtype=dtype,
            weight_norm=tc.upsample_weight_norm, device=device,
        )
        self.stack = WaveNetStack(
            dilations=tc.dilations, residual_channels=tc.residual_channels,
            gate_channels=tc.gate_channels, skip_channels=tc.skip_channels,
            out_dim=tc.head_dim, cond_channels=n_mels, dtype=dtype,
            mode=resolve_stack_mode(stack_mode or tc.fused_layers, "infer",
                                    tc.dilations),
            device=device,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.upsample.reset_parameters(generator)
        self.stack.reset_parameters(generator)

    def condition(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, F, n_mels) mel frames -> (B, F*hop, n_mels) per-sample cond."""
        return self.upsample(mel)

    def params_from_cond(self, wav: torch.Tensor,
                         cond: torch.Tensor) -> torch.Tensor:
        """Teacher forcing given the conditioning: wav (B, T) in [-1, 1],
        cond (B, T, n_mels) -> head params (B, T, head_dim) in fp32; params[t]
        models wav[t] given wav[<t]."""
        return self.stack(shift_right_scalar(wav), cond)

    def forward(self, wav: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        cond = match_length(self.condition(mel), wav.shape[-1])
        return self.params_from_cond(wav, cond)

    def loss(self, wav: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        """Mean teacher-forcing NLL (nats per sample), fp32: discretized MoL
        or continuous single-Gaussian per `teacher.output`."""
        tc = self.config.teacher
        nll = (gaussian.gaussian_nll if tc.output == "gaussian"
               else mol.discretized_mol_loss)
        return nll(wav, self(wav, mel), log_scale_min=tc.log_scale_min)


def make_teacher(config: Config, stack_mode: str | None = None,
                 device=None) -> TeacherWaveNet:
    return TeacherWaveNet(config, stack_mode=stack_mode, device=device)


def init_teacher(config: Config, generator: torch.Generator,
                 stack_mode: str | None = None, device=None) -> TeacherWaveNet:
    """A teacher with flax's initialisation scheme (truncated-normal fan-in
    kernels, zero biases) drawn from `generator` on its device, then moved
    to `device` (default: the CUDA card; the CPU only when passed
    explicitly): the shapes of `pwn_tpu.models.teacher.init_teacher`, not
    its numbers."""
    model = TeacherWaveNet(config, stack_mode=stack_mode,
                           device=generator.device)
    model.reset_parameters(generator)
    return model.to(require_cuda() if device is None else device)
