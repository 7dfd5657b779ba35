"""Training orchestration (counterpart of `pwn_tpu/training/loop.py`):
teacher training, student distillation and direct student training, in
one process or data-parallel across processes, on a wav-directory corpus
or the synthetic one.

`run_teacher_training(cfg, workdir, data_dir, num_steps=N)`,
`run_distillation(cfg, teacher_params, workdir, data_dir, num_steps=N)`
and `run_student_direct_training(cfg, workdir, data_dir, num_steps=N)` run
as the reference's do: the deterministic data stream behind a prefetch
thread, N optimizer steps, and the held-out eval at checkpoint cadence
(at the last step at least).  With a workdir they resume from its latest
checkpoint (`ckpt_<tag>/`, the data stream restarted at the restored
step), log metrics at `train.log_every` (`metrics_<tag>.jsonl`,
TensorBoard under `tb_<tag>/`), and at checkpoint cadence save, then dump
a sample from the serving parameters (`samples/step_%08d.wav` and TB
audio): the teacher's AR sample (kernel 4 on the card), the student's
parallel one (kernel 1 for student_iaf), conditioned on a held-out clip.

Data.  With a data_dir, `corpus_split` holds out every 20th wav (the val
batch, the same on every process) and each process trains on its own
partition of the rest; without one, the synthetic corpus, seeded by the
process's rank.  `train.data_engine` picks the stream: "auto" runs the C++
loader (`data/native_loader.py`) for a data_dir when
`train.native_loader` is set and the loader builds, else the Python
iterator; "native" needs a data_dir and the loader; "python" the Python
iterator; "grain" `data/grain_pipeline.py`, where grain is installed.
The engine that ran is printed once.

Processes.  Under a process group (`parallel/mesh.py::
ensure_distributed`), each process steps on its share of the global batch
and the steps average gradients and metrics across processes.  Rank 0
alone writes checkpoints, metrics, TensorBoard and sample dumps; every
rank restores the step rank 0 found committed; rank 0 finishes its last
save before the closing barrier.

The model axis.  Under `mesh.model` > 1 the loops check that each gate
half divides over it (the teacher's and the student's), then shard the
restored state over each model group (`parallel/tp.py::shard_state`): a
rank keeps its slice of every gate tensor's parameter, Adam moments and
EMA.  At checkpoint cadence every rank joins the gather of its model
group's state (`gather_state`) and rank 0 writes the whole state in the
same format, so a checkpoint resumes on any mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.data.grain_pipeline import make_grain_iterator
from pwn_tpu_torch.data.native_loader import (NativeWavCropLoader,
                                              native_available)
from pwn_tpu_torch.data.pipeline import (SyntheticSpeech, SyntheticTones,
                                        WavCropDataset, corpus_split,
                                        make_train_iterator, prefetch)
from pwn_tpu_torch.models.modules import resolve_stack_mode
from pwn_tpu_torch.models.student import StudentIAF, init_student
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.parallel.mesh import (barrier, broadcast_int,
                                         local_batch_size, process_count,
                                         process_grid, process_index)
from pwn_tpu_torch.parallel.tp import gather_state, shard_state, validate_tp
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


def build_dataset(cfg: Config, data_dir: Optional[str], split: str = "train"):
    """The training corpus of this process, or (`split="val"`) the held-out
    one, the same on every process.  With a data_dir: `WavCropDataset`
    over this process's partition of `corpus_split`'s training files, or
    over its held-out files.  Without: 64 synthetic clips seeded by the
    rank, or 8 held-out ones from a seed disjoint from every rank's."""
    if data_dir:
        train_files, val_files = corpus_split(data_dir)
        if split == "val":
            return WavCropDataset(None, cfg.dsp.sample_rate, files=val_files)
        return WavCropDataset(None, cfg.dsp.sample_rate,
                              process_index=process_index(),
                              process_count=process_count(),
                              files=train_files)
    corpus_cls = (SyntheticSpeech if cfg.train.synthetic_corpus == "speech"
                  else SyntheticTones)
    n_samples = max(cfg.train.crop_samples, cfg.dsp.sample_rate)
    if split == "val":
        return corpus_cls(n_clips=8, n_samples=n_samples,
                          sample_rate=cfg.dsp.sample_rate, seed=7919)
    return corpus_cls(n_clips=64, n_samples=n_samples,
                      sample_rate=cfg.dsp.sample_rate, seed=process_index())


def make_train_stream(cfg: Config, data_dir: Optional[str], dataset,
                      batch_size: int, start_step: int):
    """(engine, iterator of (batch_size, crop) float32 batches from
    `start_step`), the engine chosen by `train.data_engine` as the module
    docstring says, the reference's rule."""
    engine, seed = cfg.train.data_engine, cfg.train.seed
    if engine == "native" and not data_dir:
        raise RuntimeError(
            "data_engine=native requires a --data-dir (the C++ loader "
            "reads wav files); refusing to silently fall back to the "
            "synthetic Python pipeline")
    if data_dir and (engine == "native" or (
            engine == "auto" and cfg.train.native_loader
            and native_available())):
        # "native" builds here and raises the build's own error
        return "native", NativeWavCropLoader(
            None, cfg.train.crop_samples, batch_size, seed=seed,
            start_step=start_step, process_index=process_index(),
            process_count=process_count(), files=corpus_split(data_dir)[0])
    if engine == "grain":
        return "grain", make_grain_iterator(dataset, cfg, batch_size,
                                            seed=seed, start_step=start_step)
    return "python", make_train_iterator(dataset, cfg, batch_size, seed=seed,
                                         start_step=start_step)


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


def device_put(device: torch.device) -> Callable:
    """The prefetch thread's host-to-device copy of a numpy batch; it
    enters `device` first, as every thread that touches a card must."""
    def put(batch):
        t = torch.from_numpy(batch)
        if device.type != "cuda":
            return t.to(device)
        with torch.cuda.device(device):
            return t.to(device)

    return put


def _run(cfg: Config, state: TrainState, step_fn: Callable, device,
         workdir: Optional[str], data_dir: Optional[str],
         num_steps: Optional[int], tag: str,
         eval_fn: Optional[Callable] = None,
         sample_fn: Optional[Callable] = None) -> RunResult:
    grid = process_grid(cfg.mesh)  # refuses a mesh the world cannot form
    batch_size = local_batch_size(cfg.train.global_batch_size)
    dataset = build_dataset(cfg, data_dir)
    num_steps = num_steps if num_steps is not None else cfg.train.total_steps
    lead = process_index() == 0

    ckpt = logger = None
    start_step = 0
    if workdir:
        ckpt_dir = os.path.join(os.path.abspath(workdir), f"ckpt_{tag}")
        # rank 0 alone saves; the others only read the step it found
        # committed, from a directory that then exists
        ckpt = (CheckpointManager(ckpt_dir,
                                  max_to_keep=cfg.train.keep_checkpoints)
                if lead else None)
        latest = broadcast_int(ckpt.latest_step() if lead else None)
        if latest is not None:
            state, start_step = (ckpt or CheckpointManager(ckpt_dir)).restore(
                state, step=latest)
            print(f"[{tag}] resumed from step {start_step}")
        if lead:
            logger = MetricsLogger(
                os.path.join(workdir, f"metrics_{tag}.jsonl"),
                tb_dir=(os.path.join(workdir, f"tb_{tag}")
                        if cfg.train.tensorboard else None))

    if grid.model > 1:
        validate_tp(cfg.teacher.gate_channels, grid.model)
        validate_tp(cfg.student.gate_channels, grid.model)
        state = shard_state(state, grid)

    engine, it = make_train_stream(cfg, data_dir, dataset, batch_size,
                                   start_step)
    if lead:
        print(f"[{tag}] data engine: {engine}")
    batches = prefetch(it, put=device_put(device))
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
        # every rank of a model group joins the gather of its state
        full = gather_state(state) if workdir and at_ckpt else None
        if ckpt and at_ckpt:
            ckpt.save(step + 1, full)
            if sample_fn:
                wav = sample_fn(full, step + 1)
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
    barrier(device)  # after rank 0's last save is on disk
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
    the eval pass too.  `data_dir`: a wav corpus (default: synthetic)."""
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
                 and process_index() == 0 else None)
    return _run(cfg, state, step_fn, device, workdir, data_dir, num_steps,
                "teacher", eval_fn=eval_fn, sample_fn=sample_fn)


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
    device = _device(device)
    teacher = frozen_teacher(cfg, teacher_params, device)
    student, state = _student(cfg, device)
    step_fn = make_distill_train_step(student, teacher, cfg)
    eval_step = make_distill_eval_step(student, teacher, cfg)
    val_batch = torch.from_numpy(make_val_batch(
        cfg, data_dir, local_batch_size(cfg.train.global_batch_size))).to(device)
    sample_fn = (_student_sample_fn(cfg, data_dir, device) if workdir
                 and process_index() == 0 else None)
    return _run(cfg, state, step_fn, device, workdir, data_dir, num_steps,
                "student", eval_fn=lambda state: eval_step(val_batch),
                sample_fn=sample_fn)


def run_student_direct_training(cfg: Config, workdir: Optional[str] = None,
                                data_dir: Optional[str] = None,
                                num_steps: Optional[int] = None,
                                device=None) -> RunResult:
    """Direct (teacher-free) student training, as `run_distillation` without
    a teacher: the closed-form likelihood at the ground truth plus the
    power loss (`training/student_direct.py`).  Writes the same
    `ckpt_student` layout as distillation."""
    device = _device(device)
    student, state = _student(cfg, device)
    step_fn = make_student_direct_train_step(student, cfg)
    eval_step = make_student_direct_eval_step(student, cfg)
    val_batch = torch.from_numpy(make_val_batch(
        cfg, data_dir, local_batch_size(cfg.train.global_batch_size))).to(device)
    sample_fn = (_student_sample_fn(cfg, data_dir, device) if workdir
                 and process_index() == 0 else None)
    return _run(cfg, state, step_fn, device, workdir, data_dir, num_steps,
                "student", eval_fn=lambda state: eval_step(val_batch),
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
