"""Direct (teacher-free) student training: maximum likelihood on the
closed-form IAF density plus the spectral power loss (counterpart of
`pwn_tpu/training/student_direct.py`).

Given the causal context the flow chain is affine in the base noise,
x[t] = exp(log_det[t]) z0[t] + mu_total[t], so the student's per-step
output conditional is base(mu_total, exp(log_det)): Logistic for the
default base, N for `student.base="gaussian"`.  The loss is that density's
NLL at the ground truth, plus the power loss of the student's own sample.
Noise, and the averaging across processes, as in `training/distill.py`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models.modules import match_length
from pwn_tpu_torch.models.student import StudentIAF, sample_base_noise
from pwn_tpu_torch.ops import gaussian, mol
from pwn_tpu_torch.training.common import (TrainState, gradient_update,
                                           step_generator)
from pwn_tpu_torch.training.distill import spectral_power_loss
from pwn_tpu_torch.training.teacher import prepare_batch
from pwn_tpu_torch.utils.profiling import span


def direct_student_losses(student: StudentIAF, x_ref: torch.Tensor,
                          mel: torch.Tensor, cfg: Config, *,
                          generator: Optional[torch.Generator] = None,
                          z: Optional[Sequence[torch.Tensor]] = None,
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total direct-training loss and its metrics (`loss`, `ml_nll`,
    `power_loss`) for one batch in the model domain; the noise as in
    `distillation_losses`."""
    dc = cfg.distill
    if z is None:
        z = [sample_base_noise(cfg, generator, x_ref.shape)
             for _ in range(dc.n_kl_samples)]
    if len(z) != dc.n_kl_samples:
        raise ValueError(f"need {dc.n_kl_samples} noise tensors, got {len(z)}")
    density = (gaussian.gaussian_log_density if cfg.student.base == "gaussian"
               else mol.logistic_log_density)
    cond = match_length(student.upsample(mel), x_ref.shape[-1])
    acc = []
    for zi in z:
        out = student.transform(zi, cond)
        ml = -torch.mean(density(x_ref, out.mu_total, out.log_det))
        acc.append((ml, spectral_power_loss(out.wav, x_ref, cfg)))
    ml, power = (sum(t[i] for t in acc) / dc.n_kl_samples for i in range(2))
    total = dc.ml_weight * ml + dc.power_loss_weight * power
    return total, {"loss": total, "ml_nll": ml, "power_loss": power}


def make_student_direct_train_step(student: StudentIAF, cfg: Config):
    """`(state, wav, z=None) -> (state, metrics)`, as
    `make_distill_train_step` without a teacher."""

    def train_step(state: TrainState, wav: torch.Tensor,
                   z: Optional[Sequence[torch.Tensor]] = None):
        with span("train.step"):
            with span("train.prepare"):
                x_ref, mel = prepare_batch(wav, cfg)
            with span("train.forward"):
                gen = (None if z is not None else
                       step_generator(state.seed, state.step, wav.device))
                loss, metrics = direct_student_losses(
                    student, x_ref, mel, cfg, generator=gen, z=z)
            return gradient_update(state, loss, metrics, cfg.train.ema_decay)

    return train_step


def make_student_direct_eval_step(student: StudentIAF, cfg: Config):
    """`(wav) -> metrics` under no_grad, noise from seed 0."""

    @torch.no_grad()
    def eval_step(wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        x_ref, mel = prepare_batch(wav, cfg)
        gen = torch.Generator(device=wav.device).manual_seed(0)
        return direct_student_losses(student, x_ref, mel, cfg,
                                     generator=gen)[1]

    return eval_step
