"""The port's dry run of its distributed surface (counterpart of the
reference's `__graft_entry__.py`).

`entry()`: the flagship forward, student_iaf's mel -> waveform in one
parallel pass, and example arguments.

`dryrun_multichip(n)`, called by each of n processes (`torchrun
--nproc-per-node n`, or any launcher's environment; `device="cpu"` runs it
on Gloo without a card): on one `dp x tp` mesh (tp = 2 when n is even)

* one teacher step with the state sharded over the model axis;
* sampled and Gaussian (closed-form) distillation steps, the students'
  states sharded, the teachers whole;
* batch-sharded generation from the sharded student state;
* overlap-recompute sequence parallelism;

then, on the pure data-parallel mesh `n x 1`, one teacher step and one
contrastive distillation step at 2 rows a rank.  The model is tiny_teacher
at the widths the card's kernels are built for (80 mels, bf16 compute), so
the same run goes through the kernels on a card and through their plain
versions on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pwn_tpu_torch.config import Config, get_config, override

DRYRUN_OVERRIDES = {
    "dsp.n_mels": 80, "teacher.compute_dtype": "bfloat16",
    "student.compute_dtype": "bfloat16", "train.crop_samples": 1024,
}


def entry(device=None):
    """(fn, example_args): student_iaf's `generate` on a (4, 32) mel."""
    from pwn_tpu_torch.models.student import init_student
    from pwn_tpu_torch.utils.platform import require_cuda

    device = require_cuda() if device is None else torch.device(device)
    cfg = get_config("student_iaf")
    model = init_student(cfg, torch.Generator().manual_seed(0), device=device)

    def fn(model, generator, mel):
        return model.generate(generator, mel)

    mel = torch.zeros((4, 32, cfg.dsp.n_mels), device=device)
    return fn, (model, torch.Generator(device=device).manual_seed(1), mel)


def _config(**overrides) -> Config:
    cfg = get_config("tiny_teacher")
    for k, v in {**DRYRUN_OVERRIDES, **overrides}.items():
        cfg = override(cfg, k, v)
    return cfg


def _rows(global_rows: int, seed: int, device) -> torch.Tensor:
    """This rank's rows of a seeded global batch of 1,024-sample crops."""
    from pwn_tpu_torch.parallel.mesh import process_count, process_index

    wav = np.random.default_rng(seed).uniform(
        -0.5, 0.5, (global_rows, 1024)).astype(np.float32)
    per = global_rows // process_count()
    r = process_index()
    return torch.from_numpy(wav[r * per: (r + 1) * per]).to(device)


def _finite(metrics: dict, what: str) -> dict:
    out = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in out.values()):
        raise RuntimeError(f"{what}: non-finite metrics {out}")
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run (module docstring) on this process's rank; every rank
    calls it.  Returns the steps' metrics and the generated shapes, and
    prints one summary line on rank 0."""
    from pwn_tpu_torch.models.student import StudentIAF, init_student
    from pwn_tpu_torch.models.teacher import init_teacher
    from pwn_tpu_torch.parallel.mesh import (ensure_distributed,
                                             process_count, process_grid,
                                             process_index)
    from pwn_tpu_torch.parallel.sp import make_sp_generate_mega
    from pwn_tpu_torch.parallel.tp import (make_batch_sharded_generate,
                                           shard_state, validate_tp)
    from pwn_tpu_torch.training.common import create_train_state
    from pwn_tpu_torch.training.distill import make_distill_train_step
    from pwn_tpu_torch.training.loop import frozen_teacher
    from pwn_tpu_torch.training.teacher import make_teacher_train_step
    from pwn_tpu_torch.utils.platform import require_cuda

    device = require_cuda() if device is None else torch.device(device)
    ensure_distributed(device)
    n = process_count()
    if n != n_devices:
        raise RuntimeError(f"need {n_devices} processes, have {n}")
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    cfg = _config(**{"mesh.data": dp, "mesh.model": tp,
                     "train.global_batch_size": n})
    grid = process_grid(cfg.mesh)
    validate_tp(cfg.teacher.gate_channels, tp)
    validate_tp(cfg.student.gate_channels, tp)
    wav = _rows(n, 0, device)

    def state_of(model, seed=None):
        return shard_state(create_train_state(dict(model.named_parameters()),
                                              cfg.train, seed=seed), grid)

    # the teacher step on the dp x tp mesh, its state sharded
    teacher = init_teacher(cfg, torch.Generator().manual_seed(0),
                           stack_mode="train", device=device)
    t_state, m = make_teacher_train_step(teacher, cfg)(state_of(teacher), wav)
    out = {"teacher": _finite(m, "teacher step")}

    # sampled distillation: the student sharded, the frozen teacher whole
    student = init_student(cfg, torch.Generator().manual_seed(1),
                           stack_mode="train", device=device)
    s_state = state_of(student, seed=2)
    step = make_distill_train_step(
        student, frozen_teacher(cfg, teacher.state_dict(), device), cfg)
    s_state, m = step(s_state, wav)
    out["distill"] = _finite(m, "distillation step")

    # the Gaussian family (closed-form KL) on the same mesh
    g_cfg = override(override(cfg, "teacher.output", "gaussian"),
                     "student.base", "gaussian")
    g_teacher = init_teacher(g_cfg, torch.Generator().manual_seed(5),
                             device=device)
    g_student = init_student(g_cfg, torch.Generator().manual_seed(6),
                             stack_mode="train", device=device)
    g_step = make_distill_train_step(
        g_student, frozen_teacher(g_cfg, g_teacher.state_dict(), device),
        g_cfg)
    _, m = g_step(shard_state(create_train_state(
        dict(g_student.named_parameters()), g_cfg.train, seed=7), grid), wav)
    out["closed_form"] = _finite(m, "closed-form distillation step")
    if out["closed_form"]["kl"] < 0.0:
        raise RuntimeError("the closed-form KL is negative")

    # batch-sharded generation from the sharded student state, and
    # overlap-recompute SP
    gen_model = StudentIAF(cfg, device=device)
    wav_b = make_batch_sharded_generate(cfg)(
        gen_model, 4, torch.zeros((n, 8, cfg.dsp.n_mels), device=device),
        state=s_state)
    wav_sp = make_sp_generate_mega(cfg)(
        gen_model, 5, torch.zeros((1, 40 * n, cfg.dsp.n_mels), device=device))
    for name, w in (("batch-sharded", wav_b), ("sequence-parallel", wav_sp)):
        if not torch.isfinite(w).all():
            raise RuntimeError(f"{name} generation is not finite")
    out["shapes"] = {"batch": tuple(wav_b.shape), "sp": tuple(wav_sp.shape)}

    # the pure data-parallel mesh: a teacher step, and contrastive
    # distillation at 2 rows a rank (the roll mismatches within a rank)
    dp_cfg = _config(**{"mesh.data": n, "mesh.model": 1,
                        "train.global_batch_size": n})
    dp_teacher = init_teacher(dp_cfg, torch.Generator().manual_seed(0),
                              stack_mode="train", device=device)
    _, m = make_teacher_train_step(dp_teacher, dp_cfg)(
        create_train_state(dict(dp_teacher.named_parameters()),
                           dp_cfg.train), _rows(n, 1, device))
    out["dp_teacher"] = _finite(m, "data-parallel teacher step")
    c_cfg = _config(**{"mesh.data": n, "mesh.model": 1,
                       "train.global_batch_size": 2 * n,
                       "distill.contrastive_weight": 0.3})
    c_student = init_student(c_cfg, torch.Generator().manual_seed(8),
                             stack_mode="train", device=device)
    c_teacher = init_teacher(c_cfg, torch.Generator().manual_seed(10),
                             device=device)
    c_step = make_distill_train_step(
        c_student, frozen_teacher(c_cfg, c_teacher.state_dict(), device),
        c_cfg)
    _, m = c_step(create_train_state(dict(c_student.named_parameters()),
                                     c_cfg.train, seed=9),
                  _rows(2 * n, 2, device))
    out["contrastive"] = _finite(m, "contrastive distillation step")
    if process_index() == 0:
        print(f"dryrun_multichip({n}) ok on {dp}x{tp} (data,model) mesh: "
              f"teacher loss {out['teacher']['loss']:.3f}, distill loss "
              f"{out['distill']['loss']:.3f}, contrastive KL "
              f"{out['contrastive']['contrastive_kl']:.3f}, closed-form KL "
              f"{out['closed_form']['kl']:.3f}, generation batch"
              f"{out['shapes']['batch']} sp{out['shapes']['sp']}, dp train "
              f"loss {out['dp_teacher']['loss']:.3f}")
    return out
