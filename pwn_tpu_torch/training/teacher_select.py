"""Distillability-aware teacher-checkpoint selection (counterpart of
`pwn_tpu/training/teacher_select.py`).

Teacher quality and distillability are separate axes: the reference's
measurements found an overtrained teacher (better val NLL) distilling 3x
worse than an earlier checkpoint.  So the probe distils a fresh student
for a few steps against each retained teacher checkpoint and picks the one
with the lowest held-out distillation loss.

One student model, one frozen teacher model and one step function serve
every candidate: each candidate's parameters are copied into the teacher
in place, and the student is reset to the same initial parameters, with a
fresh optimizer state and the identical data stream, so the teacher is
the only varying factor.

CLI: `distill-student <case> --teacher-step auto` (see cli.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.data.pipeline import make_train_iterator
from pwn_tpu_torch.parallel.mesh import local_batch_size
from pwn_tpu_torch.training.common import create_train_state, serving_params
from pwn_tpu_torch.training.distill import (make_distill_eval_step,
                                            make_distill_train_step)
from pwn_tpu_torch.training.loop import (_ckpt_dir, _device, _student,
                                         build_dataset, frozen_teacher,
                                         make_val_batch, state_template,
                                         teacher_checkpoint_steps)
from pwn_tpu_torch.utils.checkpoint import CheckpointManager


def probe_teacher_checkpoints(
    cfg: Config,
    teacher_workdir: str,
    teacher_cfg: Optional[Config] = None,
    data_dir: Optional[str] = None,
    probe_steps: int = 500,
    candidates: Optional[List[int]] = None,
    prefer_ema: bool = True,
    device=None,
) -> List[Dict[str, Any]]:
    """Short-distil every candidate teacher checkpoint (default: every
    retained one); return each one's held-out metrics, ascending by
    teacher step: `[{"teacher_step", "val_kl", "val_power_loss",
    "val_loss", ...}]`."""
    tcfg = teacher_cfg or cfg
    if candidates is None:
        candidates = teacher_checkpoint_steps(teacher_workdir)
    if not candidates:
        raise FileNotFoundError(
            f"no teacher checkpoints under {teacher_workdir}")
    device = _device(device)

    t_template = state_template(tcfg, "teacher", device)
    mngr = CheckpointManager(_ckpt_dir(teacher_workdir, "teacher"))
    teacher = frozen_teacher(tcfg, t_template.params, device)
    student, state0 = _student(cfg, device)
    s_params0 = {k: v.detach().clone() for k, v in student.state_dict().items()}
    step_fn = make_distill_train_step(student, teacher, cfg)
    eval_step = make_distill_eval_step(student, teacher, cfg)

    lbs = local_batch_size(cfg.train.global_batch_size)
    val_batch = torch.from_numpy(make_val_batch(cfg, data_dir, lbs)).to(device)
    dataset = build_dataset(cfg, data_dir)

    results: List[Dict[str, Any]] = []
    for t_step in sorted(candidates):
        t_state, _ = mngr.restore(t_template, step=t_step)
        teacher.load_state_dict(serving_params(t_state) if prefer_ema
                                else t_state.params)
        student.load_state_dict(s_params0)
        state = create_train_state(dict(student.named_parameters()),
                                   cfg.train, seed=state0.seed)
        it = make_train_iterator(dataset, cfg, lbs, seed=cfg.train.seed,
                                 start_step=0)
        for _ in range(probe_steps):
            state, _m = step_fn(state, torch.from_numpy(next(it)).to(device))
        val = {f"val_{k}": float(v) for k, v in eval_step(val_batch).items()}
        results.append({"teacher_step": int(t_step), **val})
        print(f"[teacher-probe] step {t_step}: "
              f"val_kl {val.get('val_kl', float('nan')):.4f} "
              f"val_power {val.get('val_power_loss', float('nan')):.4f}",
              flush=True)
    mngr.close()
    return results


def select_teacher_step(
    cfg: Config,
    teacher_workdir: str,
    teacher_cfg: Optional[Config] = None,
    data_dir: Optional[str] = None,
    probe_steps: int = 500,
    candidates: Optional[List[int]] = None,
    prefer_ema: bool = True,
    criterion: str = "val_loss",
    device=None,
) -> int:
    """The candidate teacher step with the lowest probe `criterion`.

    The default criterion is the TOTAL probe loss (KL + power at full
    weight), not the KL alone: an early, noisy teacher is the easiest to
    match in KL, yet its distilled student inherits the teacher's noise
    floor; the power term scores the student against the ground-truth
    waveform, which exposes that failure.
    """
    results = probe_teacher_checkpoints(
        cfg, teacher_workdir, teacher_cfg=teacher_cfg, data_dir=data_dir,
        probe_steps=probe_steps, candidates=candidates,
        prefer_ema=prefer_ema, device=device)
    best = min(results, key=lambda r: r.get(criterion, float("inf")))
    print(f"[teacher-probe] selected teacher step "
          f"{best['teacher_step']} ({criterion} "
          f"{best.get(criterion):.4f})", flush=True)
    return best["teacher_step"]
