"""Probability-density distillation of the student IAF from a frozen
teacher (counterpart of `pwn_tpu/training/distill.py`).

    L = w_kl * KL(p_S || p_T) + w_pow * || |STFT(x_S)| - |STFT(x_ref)| ||^2

with the KL estimated pathwise per base-noise sample z:

    KL ~ E_z[ log p_S(x_S(z)) - log p_T(x_S(z)) ]

`log p_S` is the student's closed-form density (`StudentOutput.
log_p_student`); `log p_T` is the teacher's continuous density of the
student's own sample, from one teacher-forcing pass.  The teacher is
frozen: its parameters do not require grad, and the loop builds its stack
in the "dx" mode (kernel 3 without weight gradients on the card), as the
reference scores it with mega_dx.  Gradients reach the student pathwise
through x_S.  `objective="closed_form"` (a Gaussian teacher and a Gaussian
student base) takes ClariNet's exact per-step KL with its log-sigma
regulariser instead; `distill.contrastive_weight` > 0 adds Parallel
WaveNet's contrastive term, the same sample scored under the batch's mels
rolled by one, within each process's batch as the reference rolls within
each shard; a batch of 1 there is refused, since its roll is the
identity and the loss would silently become (1 - w) * KL.

Noise: a `torch.Generator` per step seeded from (state.seed, state.step)
and the process's rank (`training/common.py::step_generator`), as the
reference folds the data shard's index into the step key; `z=` takes
pre-drawn noise, one (B, T) tensor per KL sample.  The eval draws from
seed 0, as the reference's eval uses `PRNGKey(0)`.  Under a process group
the gradients and metrics are averaged across processes before the clip.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models.modules import match_length
from pwn_tpu_torch.models.student import StudentIAF, sample_base_noise
from pwn_tpu_torch.models.teacher import TeacherWaveNet
from pwn_tpu_torch.ops import gaussian, mol
from pwn_tpu_torch.training.common import (TrainState, gradient_update,
                                           step_generator)
from pwn_tpu_torch.training.teacher import prepare_batch
from pwn_tpu_torch.utils import dsp
from pwn_tpu_torch.utils.profiling import span


def spectral_power_loss(x_s: torch.Tensor, x_ref: torch.Tensor,
                        cfg: Config) -> torch.Tensor:
    """Mean squared STFT-magnitude error, averaged over the cfg.dsp
    resolution and every `distill.power_loss_resolutions` (n_fft, hop,
    win) triple."""
    resolutions = ((cfg.dsp.n_fft, cfg.dsp.hop_length, cfg.dsp.win_length),
                   *(tuple(r) for r in cfg.distill.power_loss_resolutions))
    total = 0.0
    for n_fft, hop, win in resolutions:
        mag_s = dsp.stft_magnitude(x_s, n_fft, hop, win)
        mag_r = dsp.stft_magnitude(x_ref, n_fft, hop, win)
        total = total + torch.mean(torch.square(mag_s - mag_r))
    return total / len(resolutions)


def resolve_objective(cfg: Config) -> str:
    """`distill.objective` -> "sampled" | "closed_form".  "auto" is
    closed_form for a Gaussian teacher with a Gaussian student base, else
    sampled; closed_form asks for both."""
    obj = cfg.distill.objective
    is_gg = (cfg.teacher.output == "gaussian"
             and cfg.student.base == "gaussian")
    if obj == "auto":
        return "closed_form" if is_gg else "sampled"
    if obj == "closed_form" and not is_gg:
        raise ValueError(
            "distill.objective='closed_form' requires "
            "teacher.output='gaussian' and student.base='gaussian' "
            f"(got {cfg.teacher.output!r}/{cfg.student.base!r})")
    if obj not in ("sampled", "closed_form"):
        raise ValueError(f"unknown distill.objective {obj!r}")
    return obj


def kl_weight_at(cfg: Config, step: Optional[int]) -> float:
    """The KL weight, ramped linearly over `distill.kl_warmup_steps`
    (constant when that is 0 or step is None: the eval scores at full
    weight)."""
    dc = cfg.distill
    if step is None or dc.kl_warmup_steps <= 0:
        return dc.kl_weight
    return dc.kl_weight * min((step + 1.0) / dc.kl_warmup_steps, 1.0)


def _teacher_log_density(t_out: torch.Tensor, x: torch.Tensor,
                         cfg: Config) -> torch.Tensor:
    """log p_T(x) (B, T) under the teacher's head output, continuous."""
    lsm = cfg.teacher.log_scale_min
    if cfg.teacher.output == "gaussian":
        mu, log_s = gaussian.split_params(t_out)
        return gaussian.gaussian_log_density(x, mu, torch.clamp(log_s,
                                                                min=lsm))
    return mol.mol_log_density(x, t_out, lsm)


def _gaussian_kl(out, t_out: torch.Tensor, cfg: Config) -> torch.Tensor:
    """ClariNet's per-step KL(q || p_T), q = N(mu_total, exp(log_det)^2):
    (kl (B, T), the teacher's clamped log-scale)."""
    mu_t, log_s_t = gaussian.split_params(t_out)
    log_s_t = torch.clamp(log_s_t, min=cfg.teacher.log_scale_min)
    return gaussian.kl_gaussian(out.mu_total, out.log_det, mu_t,
                                log_s_t), log_s_t


def distillation_losses(student: StudentIAF, teacher: TeacherWaveNet,
                        x_ref: torch.Tensor, mel: torch.Tensor, cfg: Config,
                        *, generator: Optional[torch.Generator] = None,
                        z: Optional[Sequence[torch.Tensor]] = None,
                        step: Optional[int] = None,
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total distillation loss and its metrics (0-d fp32 tensors) for one
    batch in the model domain: x_ref (B, T), mel (B, F, n_mels).  The noise
    is `z` (one (B, T) tensor per KL sample) or drawn from `generator`.
    The student's conditioning is upsampled once and shared by the samples;
    the teacher's likewise, and the contrastive term's is that one rolled
    by one along the batch (the upsampler works per utterance, so this is
    the upsampling of the rolled mels); with the term on, a batch of 1
    raises ValueError."""
    dc = cfg.distill
    objective = resolve_objective(cfg)
    contrastive = dc.contrastive_weight > 0.0
    if contrastive and x_ref.shape[0] < 2:
        raise ValueError(
            "distill.contrastive_weight > 0 needs a batch of at least 2 per "
            f"process (got {x_ref.shape[0]}): the contrastive term rolls the "
            "mels within the batch, and a roll of one row is the identity")
    T = x_ref.shape[-1]
    if z is None:
        z = [sample_base_noise(cfg, generator, x_ref.shape)
             for _ in range(dc.n_kl_samples)]
    if len(z) != dc.n_kl_samples:
        raise ValueError(f"need {dc.n_kl_samples} noise tensors, got {len(z)}")
    s_cond = match_length(student.upsample(mel), T)
    t_cond = match_length(teacher.condition(mel), T)
    t_cond_mis = torch.roll(t_cond, 1, 0) if contrastive else None

    def one_sample(zi):
        out = student.transform(zi, s_cond)
        x_s = out.wav
        t_out = teacher.params_from_cond(x_s, t_cond)
        t_mis = (teacher.params_from_cond(x_s, t_cond_mis) if contrastive
                 else None)
        kl_mis = torch.zeros((), device=x_s.device)
        ent = torch.mean(-out.log_p_student)
        if objective == "closed_form":
            kl_t, log_s_t = _gaussian_kl(out, t_out, cfg)
            kl = torch.mean(kl_t)
            reg = torch.mean(torch.square(log_s_t - out.log_det))
            xent = kl + ent   # E_q[-log p] = KL + H(q), both exact here
            if contrastive:
                kl_mis = torch.mean(_gaussian_kl(out, t_mis, cfg)[0])
        else:
            log_p_t = _teacher_log_density(t_out, x_s, cfg)
            kl = torch.mean(out.log_p_student - log_p_t)
            reg = torch.zeros((), device=x_s.device)
            xent = torch.mean(-log_p_t)
            if contrastive:
                kl_mis = torch.mean(out.log_p_student
                                    - _teacher_log_density(t_mis, x_s, cfg))
        power = spectral_power_loss(x_s, x_ref, cfg)
        return kl, reg, power, ent, xent, kl_mis

    acc = [one_sample(zi) for zi in z]
    kl, reg, power, ent, xent, kl_mis = (
        sum(t[i] for t in acc) / dc.n_kl_samples for i in range(6))
    kl_term = kl - dc.contrastive_weight * kl_mis if contrastive else kl
    w_kl = kl_weight_at(cfg, step)
    total = w_kl * kl_term + dc.power_loss_weight * power
    metrics = {"loss": total, "kl": kl, "power_loss": power,
               "student_entropy": ent, "teacher_xent": xent}
    if contrastive:
        metrics["contrastive_kl"] = kl_mis
    if objective == "closed_form":
        # the variance regulariser rides the KL's warm-up ramp
        total = total + w_kl * (dc.log_sigma_reg_weight * reg)
        metrics["loss"] = total
        metrics["log_sigma_reg"] = reg
    return total, metrics


def make_distill_train_step(student: StudentIAF, teacher: TeacherWaveNet,
                            cfg: Config):
    """`(state, wav, z=None) -> (state, metrics)`: one optimizer step of the
    student on the distillation loss of a raw batch wav (B, T); metrics stay
    on the device, with `grad_norm`.  `state.trainable()` must be the
    student's parameters (whole or sharded over the model axis, as
    `make_teacher_train_step` says); the teacher is held whole and not
    touched.  The noise comes from
    `step_generator(state.seed, state.step)` (this process's draw) unless
    `z` is given; gradients and metrics are averaged across processes."""

    def train_step(state: TrainState, wav: torch.Tensor,
                   z: Optional[Sequence[torch.Tensor]] = None):
        with span("train.step"):
            with span("train.prepare"):
                x_ref, mel = prepare_batch(wav, cfg)
            with span("train.forward"):
                gen = (None if z is not None else
                       step_generator(state.seed, state.step, wav.device))
                loss, metrics = distillation_losses(
                    student, teacher, x_ref, mel, cfg, generator=gen, z=z,
                    step=state.step)
            return gradient_update(state, loss, metrics, cfg.train.ema_decay)

    return train_step


def make_distill_eval_step(student: StudentIAF, teacher: TeacherWaveNet,
                           cfg: Config):
    """`(wav) -> metrics`: the held-out distillation metrics under no_grad,
    with noise from seed 0 on the batch's device."""

    @torch.no_grad()
    def eval_step(wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        x_ref, mel = prepare_batch(wav, cfg)
        gen = torch.Generator(device=wav.device).manual_seed(0)
        return distillation_losses(student, teacher, x_ref, mel, cfg,
                                   generator=gen)[1]

    return eval_step
