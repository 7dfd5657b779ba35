"""Training orchestration (counterpart of `pwn_tpu/training/loop.py`):
teacher training, student distillation and direct student training on one
device, on the synthetic corpus.

`run_teacher_training(cfg, num_steps=N)`, `run_distillation(cfg,
teacher_params, num_steps=N)` and `run_student_direct_training(cfg,
num_steps=N)` run as the reference's do with no workdir: the
deterministic data iterator behind a prefetch thread, N optimizer steps,
and the held-out eval at checkpoint cadence (at the last step at least).
Not ported yet, and refused with NotImplementedError rather than skipped:
a workdir (checkpoints, metrics, TensorBoard and the AR and student sample
dumps) and a data_dir (the wav-directory corpus and its data engines).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.data.pipeline import (SyntheticSpeech, SyntheticTones,
                                        local_batch_size, make_train_iterator,
                                        prefetch)
from pwn_tpu_torch.models.modules import resolve_stack_mode
from pwn_tpu_torch.models.student import init_student
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.training.common import create_train_state
from pwn_tpu_torch.training.distill import (make_distill_eval_step,
                                            make_distill_train_step)
from pwn_tpu_torch.training.student_direct import (
    make_student_direct_eval_step, make_student_direct_train_step)
from pwn_tpu_torch.training.teacher import (make_teacher_eval_step,
                                            make_teacher_train_step)
from pwn_tpu_torch.utils.platform import require_cuda


@dataclass
class RunResult:
    state: Any
    final_metrics: dict
    steps_run: int


def _refuse(workdir: Optional[str], data_dir: Optional[str]) -> None:
    if workdir:
        raise NotImplementedError(
            "a workdir (checkpoints, metrics, TensorBoard, AR sample dumps) "
            "is not ported yet: the training loop and checkpoint slice")
    if data_dir:
        raise NotImplementedError(
            "a data_dir (the wav-directory corpus and its data engines) is "
            "not ported yet: the data-engine slice")


def build_dataset(cfg: Config, data_dir: Optional[str], split: str = "train"):
    """The synthetic corpus: 64 training clips, or 8 held-out ones from a
    seed disjoint from training's (the reference's split)."""
    _refuse(None, data_dir)
    corpus_cls = (SyntheticSpeech if cfg.train.synthetic_corpus == "speech"
                  else SyntheticTones)
    n_samples = max(cfg.train.crop_samples, cfg.dsp.sample_rate)
    if split == "val":
        return corpus_cls(n_clips=8, n_samples=n_samples,
                          sample_rate=cfg.dsp.sample_rate, seed=7919)
    return corpus_cls(n_clips=64, n_samples=n_samples,
                      sample_rate=cfg.dsp.sample_rate, seed=0)


def make_val_batch(cfg: Config, data_dir: Optional[str], batch_size: int):
    """One fixed, deterministic held-out batch (numpy, (batch, crop))."""
    ds = build_dataset(cfg, data_dir, split="val")
    return next(make_train_iterator(ds, cfg, batch_size, seed=104729,
                                    start_step=0))


def _run(cfg: Config, state, step_fn: Callable, device, num_steps: Optional[int],
         eval_fn: Optional[Callable] = None) -> RunResult:
    dataset = build_dataset(cfg, None)
    num_steps = num_steps if num_steps is not None else cfg.train.total_steps
    it = make_train_iterator(dataset, cfg,
                             local_batch_size(cfg.train.global_batch_size),
                             seed=cfg.train.seed, start_step=0)
    batches = prefetch(it, put=lambda b: torch.from_numpy(b).to(device))
    metrics: dict = {}
    for step in range(num_steps):
        state, metrics = step_fn(state, next(batches))
        at_ckpt = ((step + 1) % cfg.train.checkpoint_every == 0
                   or step + 1 == num_steps)
        if eval_fn and at_ckpt:
            val = {f"val_{k}": v for k, v in eval_fn(state).items()}
            metrics = {**metrics, **val}
    batches.close()  # stops the prefetch thread
    return RunResult(state=state,
                     final_metrics={k: float(v) for k, v in metrics.items()},
                     steps_run=num_steps)


def run_teacher_training(cfg: Config, workdir: Optional[str] = None,
                         data_dir: Optional[str] = None,
                         num_steps: Optional[int] = None,
                         device=None) -> RunResult:
    """Train the teacher for `num_steps` (default `train.total_steps`) on
    `device` (default: the CUDA card; the CPU only when passed
    explicitly).  The stack runs in the "train" mode ("auto" and "mega" map
    to it, as the reference trains them with mega_train), for the eval pass
    too."""
    _refuse(workdir, data_dir)
    device = require_cuda() if device is None else torch.device(device)
    model = init_teacher(
        cfg, torch.Generator().manual_seed(cfg.train.seed),
        stack_mode=resolve_stack_mode(cfg.teacher.fused_layers, "train"),
        device=device)
    state = create_train_state(dict(model.named_parameters()), cfg.train)
    step_fn = make_teacher_train_step(model, cfg)
    eval_step = make_teacher_eval_step(model, cfg)
    val_batch = torch.from_numpy(make_val_batch(
        cfg, data_dir, local_batch_size(cfg.train.global_batch_size))).to(device)

    def eval_fn(state):
        return {"loss": eval_step(val_batch)}

    return _run(cfg, state, step_fn, device, num_steps, eval_fn=eval_fn)


def _student(cfg: Config, device: torch.device):
    """The student being trained, seeded from train.seed + 1 (the
    reference's key), its stacks in the training mode, and its train state
    with the step noise seeded from train.seed + 2."""
    student = init_student(
        cfg, torch.Generator().manual_seed(cfg.train.seed + 1),
        stack_mode=resolve_stack_mode(cfg.student.fused_layers, "train"),
        device=device)
    state = create_train_state(dict(student.named_parameters()), cfg.train,
                               seed=cfg.train.seed + 2)
    return student, state


def frozen_teacher(cfg: Config, teacher_params: Mapping[str, torch.Tensor],
                   device) -> TeacherWaveNet:
    """The distillation teacher from the port's state dict (a flax tree goes
    through `convert.params_from_flax` first), its parameters frozen.  Its
    stack needs only its input gradient, so a whole-stack flag builds
    "dx" (kernel 3 without weight gradients on the card), as the
    reference's "auto" scores the teacher with mega_dx; "on" / "layer"
    build "layer"."""
    mode = resolve_stack_mode(cfg.teacher.fused_layers, "train")
    teacher = TeacherWaveNet(cfg, stack_mode="dx" if mode == "train" else mode,
                             device=device)
    teacher.load_state_dict(teacher_params)
    return teacher.requires_grad_(False)


def run_distillation(cfg: Config, teacher_params: Mapping[str, torch.Tensor],
                     workdir: Optional[str] = None,
                     data_dir: Optional[str] = None,
                     num_steps: Optional[int] = None,
                     device=None) -> RunResult:
    """Distil the student from the frozen teacher `teacher_params` (the
    port's state dict) for `num_steps` (default `train.total_steps`) on
    `device` (default: the CUDA card; the CPU only when passed explicitly).
    The student trains in the "train" stack mode, the teacher scores in
    "dx" (`frozen_teacher`); the held-out eval reports `val_*` metrics."""
    _refuse(workdir, data_dir)
    device = require_cuda() if device is None else torch.device(device)
    teacher = frozen_teacher(cfg, teacher_params, device)
    student, state = _student(cfg, device)
    step_fn = make_distill_train_step(student, teacher, cfg)
    eval_step = make_distill_eval_step(student, teacher, cfg)
    val_batch = torch.from_numpy(make_val_batch(
        cfg, data_dir, local_batch_size(cfg.train.global_batch_size))).to(device)
    return _run(cfg, state, step_fn, device, num_steps,
                eval_fn=lambda state: eval_step(val_batch))


def run_student_direct_training(cfg: Config, workdir: Optional[str] = None,
                                data_dir: Optional[str] = None,
                                num_steps: Optional[int] = None,
                                device=None) -> RunResult:
    """Direct (teacher-free) student training, as `run_distillation` without
    a teacher: the closed-form likelihood at the ground truth plus the
    power loss (`training/student_direct.py`)."""
    _refuse(workdir, data_dir)
    device = require_cuda() if device is None else torch.device(device)
    student, state = _student(cfg, device)
    step_fn = make_student_direct_train_step(student, cfg)
    eval_step = make_student_direct_eval_step(student, cfg)
    val_batch = torch.from_numpy(make_val_batch(
        cfg, data_dir, local_batch_size(cfg.train.global_batch_size))).to(device)
    return _run(cfg, state, step_fn, device, num_steps,
                eval_fn=lambda state: eval_step(val_batch))
