"""Training orchestration (counterpart of `pwn_tpu/training/loop.py`):
teacher training, student distillation and direct student training on one
device, on the synthetic corpus.

`run_teacher_training(cfg, workdir, num_steps=N)`, `run_distillation(cfg,
teacher_params, workdir, num_steps=N)` and `run_student_direct_training(
cfg, workdir, num_steps=N)` run as the reference's do: the deterministic
data iterator behind a prefetch thread, N optimizer steps, and the
held-out eval at checkpoint cadence (at the last step at least).  With a
workdir they resume from its latest checkpoint (`ckpt_<tag>/`, the data
stream restarted at the restored step), log metrics at `train.log_every`
(`metrics_<tag>.jsonl`, TensorBoard under `tb_<tag>/`), and at checkpoint
cadence save, then dump a sample from the serving parameters
(`samples/step_%08d.wav` and TB audio): the teacher's AR sample (kernel 4
on the card), the student's parallel one (kernel 1 for student_iaf).

Not ported yet, and refused rather than skipped: a data_dir (the
wav-directory corpus) and the "native" and "grain" data engines.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.data.pipeline import (SyntheticSpeech, SyntheticTones,
                                        local_batch_size, make_train_iterator,
                                        prefetch)
from pwn_tpu_torch.models.modules import resolve_stack_mode
from pwn_tpu_torch.models.student import StudentIAF, init_student
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.training.common import (TrainState, create_train_state,
                                           serving_params)
from pwn_tpu_torch.training.distill import (make_distill_eval_step,
                                            make_distill_train_step)
from pwn_tpu_torch.training.student_direct import (
    make_student_direct_eval_step, make_student_direct_train_step)
from pwn_tpu_torch.training.teacher import (make_teacher_eval_step,
                                            make_teacher_train_step)
from pwn_tpu_torch.utils.audio_io import write_wav
from pwn_tpu_torch.utils.checkpoint import CheckpointManager
from pwn_tpu_torch.utils.metrics import MetricsLogger
from pwn_tpu_torch.utils.platform import require_cuda
from pwn_tpu_torch.utils.profiling import StepProfiler, apply_debug_flags


@dataclass
class RunResult:
    state: Any
    final_metrics: dict
    steps_run: int


def _refuse(data_dir: Optional[str]) -> None:
    if data_dir:
        raise NotImplementedError(
            "a data_dir (the wav-directory corpus and its data engines) is "
            "not ported yet: the data-engine slice")


def _check_engine(cfg: Config) -> None:
    """`train.data_engine` as the reference reads it without a data_dir:
    "auto" and "python" run the Python iterator; "native" needs wav files
    and refuses; "grain" is not ported."""
    engine = cfg.train.data_engine
    if engine == "native":
        raise RuntimeError(
            "data_engine=native requires a --data-dir (the C++ loader "
            "reads wav files); refusing to silently fall back to the "
            "synthetic Python pipeline")
    if engine == "grain":
        raise NotImplementedError(
            "data_engine='grain' is not ported yet: the data-engine slice")


def build_dataset(cfg: Config, data_dir: Optional[str], split: str = "train"):
    """The synthetic corpus: 64 training clips, or 8 held-out ones from a
    seed disjoint from training's (the reference's split)."""
    _refuse(data_dir)
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


def _dump_mel(cfg: Config, data_dir: Optional[str], device) -> torch.Tensor:
    """The sample dumps' conditioning: held-out clip 0, cropped to
    `train.eval_sample_seconds` (at least 4 frames)."""
    from pwn_tpu_torch.generate import mel_from_wav

    n = max(cfg.dsp.hop_length * 4,
            int(cfg.train.eval_sample_seconds * cfg.dsp.sample_rate))
    clip = build_dataset(cfg, data_dir, split="val")[0][:n]
    return mel_from_wav(cfg, clip, device)


def _sample_fn(cfg: Config, data_dir: Optional[str], device, model,
               synthesize: Callable):
    """`(state, step) -> wav`: load the serving parameters (the EMA when it
    is tracked) into `model`, a copy built for synthesis, and run
    `synthesize(model, mel, generator)` with noise seeded by the step."""
    mel = _dump_mel(cfg, data_dir, device)

    def sample_fn(state: TrainState, step: int):
        model.load_state_dict(serving_params(state))
        gen = torch.Generator(device=device).manual_seed(step)
        return synthesize(model, mel, gen)

    return sample_fn


def _teacher_sample_fn(cfg: Config, data_dir: Optional[str], device):
    """The teacher's dump: `generate_teacher` at temperature 0.8 on an
    inference-mode teacher (kernel 4 on the card)."""
    from pwn_tpu_torch.generate import generate_teacher

    return _sample_fn(
        cfg, data_dir, device, TeacherWaveNet(cfg, device=device),
        lambda m, mel, gen: generate_teacher(cfg, m, mel, gen,
                                             temperature=0.8))


def _student_sample_fn(cfg: Config, data_dir: Optional[str], device):
    """The student's dump: `generate_student` on a student whose stacks run
    the inference mode, as `generate` builds it (kernel 1 for
    student_iaf)."""
    from pwn_tpu_torch.generate import generate_student

    return _sample_fn(
        cfg, data_dir, device, StudentIAF(cfg, device=device),
        lambda m, mel, gen: generate_student(cfg, m, mel, gen))


def _run(cfg: Config, state: TrainState, step_fn: Callable, device,
         workdir: Optional[str], num_steps: Optional[int], tag: str,
         eval_fn: Optional[Callable] = None,
         sample_fn: Optional[Callable] = None) -> RunResult:
    _check_engine(cfg)
    dataset = build_dataset(cfg, None)
    num_steps = num_steps if num_steps is not None else cfg.train.total_steps

    ckpt = logger = None
    start_step = 0
    if workdir:
        ckpt = CheckpointManager(
            os.path.join(os.path.abspath(workdir), f"ckpt_{tag}"),
            max_to_keep=cfg.train.keep_checkpoints)
        if ckpt.latest_step() is not None:
            state, start_step = ckpt.restore(state)
            print(f"[{tag}] resumed from step {start_step}")
        logger = MetricsLogger(
            os.path.join(workdir, f"metrics_{tag}.jsonl"),
            tb_dir=(os.path.join(workdir, f"tb_{tag}")
                    if cfg.train.tensorboard else None))

    it = make_train_iterator(dataset, cfg,
                             local_batch_size(cfg.train.global_batch_size),
                             seed=cfg.train.seed, start_step=start_step)
    batches = prefetch(it, put=lambda b: torch.from_numpy(b).to(device))
    apply_debug_flags()
    profiler = StepProfiler()
    metrics: dict = {}
    for step in range(start_step, num_steps):
        profiler.step(step)
        state, metrics = step_fn(state, next(batches))
        if logger and (step % cfg.train.log_every == 0
                       or step + 1 == num_steps):
            logger.log(step, **metrics)
        at_ckpt = ((step + 1) % cfg.train.checkpoint_every == 0
                   or step + 1 == num_steps)
        if eval_fn and at_ckpt:
            val = {f"val_{k}": float(v) for k, v in eval_fn(state).items()}
            if logger:
                logger.log(step + 1, **val)
            metrics = {**metrics, **val}
        if ckpt and at_ckpt:
            ckpt.save(step + 1, state)
            if sample_fn:
                wav = sample_fn(state, step + 1)
                write_wav(os.path.join(workdir, "samples",
                                       f"step_{step + 1:08d}.wav"),
                          wav, cfg.dsp.sample_rate)
                logger.add_audio(step + 1, "samples/audio", wav,
                                 cfg.dsp.sample_rate)
    batches.close()  # stops the prefetch thread
    profiler.close()
    if ckpt:
        ckpt.wait()
        ckpt.close()
    if logger:
        logger.close()
    return RunResult(state=state,
                     final_metrics={k: float(v) for k, v in metrics.items()},
                     steps_run=num_steps - start_step)


def _device(device):
    return require_cuda() if device is None else torch.device(device)


def run_teacher_training(cfg: Config, workdir: Optional[str] = None,
                         data_dir: Optional[str] = None,
                         num_steps: Optional[int] = None,
                         device=None) -> RunResult:
    """Train the teacher for `num_steps` (default `train.total_steps`) on
    `device` (default: the CUDA card; the CPU only when passed
    explicitly), with checkpoints, metrics and AR sample dumps in
    `workdir` when given.  The stack runs in the "train" mode ("auto" and
    "mega" map to it, as the reference trains them with mega_train), for
    the eval pass too."""
    _refuse(data_dir)
    device = _device(device)
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

    sample_fn = (_teacher_sample_fn(cfg, data_dir, device) if workdir
                 else None)
    return _run(cfg, state, step_fn, device, workdir, num_steps, "teacher",
                eval_fn=eval_fn, sample_fn=sample_fn)


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
    build "layer".  Another candidate's parameters load into it in place
    (`load_state_dict`)."""
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
    "dx" (`frozen_teacher`); the held-out eval reports `val_*` metrics.
    With a workdir: `ckpt_student/`, `metrics_student.jsonl` and student
    sample dumps."""
    _refuse(data_dir)
    device = _device(device)
    teacher = frozen_teacher(cfg, teacher_params, device)
    student, state = _student(cfg, device)
    step_fn = make_distill_train_step(student, teacher, cfg)
    eval_step = make_distill_eval_step(student, teacher, cfg)
    val_batch = torch.from_numpy(make_val_batch(
        cfg, data_dir, local_batch_size(cfg.train.global_batch_size))).to(device)
    sample_fn = (_student_sample_fn(cfg, data_dir, device) if workdir
                 else None)
    return _run(cfg, state, step_fn, device, workdir, num_steps, "student",
                eval_fn=lambda state: eval_step(val_batch),
                sample_fn=sample_fn)


def run_student_direct_training(cfg: Config, workdir: Optional[str] = None,
                                data_dir: Optional[str] = None,
                                num_steps: Optional[int] = None,
                                device=None) -> RunResult:
    """Direct (teacher-free) student training, as `run_distillation` without
    a teacher: the closed-form likelihood at the ground truth plus the
    power loss (`training/student_direct.py`).  Writes the same
    `ckpt_student` layout as distillation."""
    _refuse(data_dir)
    device = _device(device)
    student, state = _student(cfg, device)
    step_fn = make_student_direct_train_step(student, cfg)
    eval_step = make_student_direct_eval_step(student, cfg)
    val_batch = torch.from_numpy(make_val_batch(
        cfg, data_dir, local_batch_size(cfg.train.global_batch_size))).to(device)
    sample_fn = (_student_sample_fn(cfg, data_dir, device) if workdir
                 else None)
    return _run(cfg, state, step_fn, device, workdir, num_steps, "student",
                eval_fn=lambda state: eval_step(val_batch),
                sample_fn=sample_fn)


def state_template(cfg: Config, kind: str, device) -> TrainState:
    """A TrainState to restore a `kind` ("teacher" or "student") checkpoint
    into: the model built on `device` with unset parameters, and its
    optimizer and EMA state.  The reference restores into a shape-only
    template to skip a JAX compile; the port has no compile to skip, so it
    builds the model and restores into its own tensors."""
    cls = TeacherWaveNet if kind == "teacher" else StudentIAF
    # any mode holds the same parameters; "train" builds at every dilation
    model = cls(cfg, stack_mode="train", device=device)
    return create_train_state(dict(model.named_parameters()), cfg.train)


def _ckpt_dir(workdir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(workdir), f"ckpt_{tag}")


def restore_serving_params(cfg: Config, workdir: str, kind: str,
                           step: Optional[int] = None,
                           prefer_ema: bool = True,
                           device=None) -> Tuple[Dict[str, torch.Tensor], int]:
    """The parameters of a `kind` checkpoint in `workdir` (default: the
    latest step) as the port's state dict on `device`, and the step: the
    EMA when the checkpoint carries it and `prefer_ema`, else the live
    parameters."""
    device = _device(device)
    ckpt = CheckpointManager(_ckpt_dir(workdir, kind))
    state, step = ckpt.restore(state_template(cfg, kind, device), step=step)
    ckpt.close()
    params = serving_params(state) if prefer_ema else state.params
    return {k: v.detach() for k, v in params.items()}, step


def load_teacher_params(cfg: Config, workdir: str,
                        step: Optional[int] = None,
                        prefer_ema: bool = True,
                        device=None) -> Tuple[Dict[str, torch.Tensor], int]:
    """Restore the teacher's parameters from a training workdir (the frozen
    distillation input): the EMA when the checkpoint carries it and
    `prefer_ema` (Parallel WaveNet distils from the averaged teacher),
    else the live parameters; `step` picks a retained checkpoint (default:
    the latest).  Returns (state dict on `device`, step)."""
    return restore_serving_params(cfg, workdir, "teacher", step, prefer_ema,
                                  device)


def teacher_checkpoint_steps(workdir: str) -> List[int]:
    """Retained teacher checkpoint steps in a workdir, ascending."""
    return CheckpointManager(_ckpt_dir(workdir, "teacher")).all_steps()
