"""Teacher training and eval steps (counterpart of
`pwn_tpu/training/teacher.py`).

The host ships raw fixed-length waveform crops; preemphasis, the clip to
[-1, 1] and the mel spectrogram run on the batch's device.  The model
works in the preemphasized domain.  Under a process group each process
steps on its share of the batch and the gradients and the loss are
averaged across processes before the clip (the reference's `shard_map`
branch and its `pmean`).  The same steps run a state sharded over the
model axis (`parallel/tp.py`): they differentiate the model's whole
parameters, and the state updates its slices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models.teacher import TeacherWaveNet
from pwn_tpu_torch.training.common import TrainState, gradient_update
from pwn_tpu_torch.utils import dsp
from pwn_tpu_torch.utils.profiling import span


def prepare_batch(wav: torch.Tensor,
                  cfg: Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw wav (B, T) -> (model-domain x (B, T), mel (B, T // hop, n_mels))
    on wav's device."""
    x = torch.clamp(dsp.preemphasis(wav.float(), cfg.dsp.preemphasis),
                    -1.0, 1.0)
    mel = dsp.mel_spectrogram(x, cfg.dsp)
    return x, mel[:, : wav.shape[-1] // cfg.dsp.hop_length]


def make_teacher_train_step(model: TeacherWaveNet, cfg: Config):
    """`(state, wav) -> (state, metrics)`: one optimizer step on the
    teacher-forcing NLL; metrics `loss` and `grad_norm` stay on the device
    (0-d fp32 tensors), averaged across processes with the gradients.
    `state.trainable()` must be the model's parameters (a state sharded
    over the model axis holds slices of the gate tensors and updates them
    there, `TrainState.apply_gradients`)."""

    def train_step(state: TrainState, wav: torch.Tensor):
        with span("train.step"):
            with span("train.prepare"):
                x, mel = prepare_batch(wav, cfg)
            with span("train.forward"):
                loss = model.loss(x, mel)
            return gradient_update(state, loss, {"loss": loss},
                                   cfg.train.ema_decay)

    return train_step


def make_teacher_eval_step(model: TeacherWaveNet, cfg: Config):
    """`(wav) -> loss`: the validation NLL under no_grad, through the same
    model (in the "train" stack mode its forward runs the train kernel and
    drops the saved inputs)."""

    @torch.no_grad()
    def eval_step(wav: torch.Tensor) -> torch.Tensor:
        x, mel = prepare_batch(wav, cfg)
        return model.loss(x, mel)

    return eval_step
