"""Teacher training: the program's train step (`training/teacher.py::
make_teacher_train_step`, clipped Adam from `training/common.py`) fed by
its synthetic-corpus stream and prefetch thread (`training/loop.py::
make_train_stream`, `data/pipeline.py::prefetch`), as
`run_teacher_training` feeds it without a workdir.

Set-up builds one model, optimizer state, step and feed from the seed
(the benchmark's weights; the stream's seed drawn from the run's seed),
drives the first `checked_steps` steps and `warm_steps` more through the
same call and feed, and hands that same state to the window, whose steps
run back to back.  A traced run first runs `dispatch_seconds` of steps
untraced, whose host-clock spans give the step's host work and whose rate
gives the step's time with no profiler on, and then the profiled window,
whose trace gives the device's time a step.  The check follows the first three steps with the
reference on the same batches (rebuilt by the benchmark's frozen copy of
the corpus and crops): each step's loss, the first gradient as the
optimizer got it (Adam's first moment after one step over 1 - b1), and
the parameters' change after the three, each by its worst leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import params, traffic_gen
from perfbench.core import Outcome
from perfbench.drivers import common
from perfbench.reference import wavenet as ref

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding, and moves under Adam by round-off alone
NOUGHT = 1e-3


def run(ctx):
    from pwn_tpu_torch.config import override
    from pwn_tpu_torch.data.pipeline import prefetch
    from pwn_tpu_torch.models.modules import resolve_stack_mode
    from pwn_tpu_torch.models.teacher import TeacherWaveNet
    from pwn_tpu_torch.training.common import TrainState, create_train_state
    from pwn_tpu_torch.training.loop import (build_dataset, device_put,
                                             make_train_stream)
    from pwn_tpu_torch.training.teacher import make_teacher_train_step

    t, z, dsp = ctx.traffic, ctx.sizes(), ctx.config["dsp"]
    tr = ctx.config["train"]
    s_w, s_stream = ctx.sub_seeds(2)
    stream_seed = s_stream % (1 << 31)
    cfg = override(ctx.program_config(), "train.seed", stream_seed)
    B, crop = tr["global_batch_size"], tr["crop_samples"]
    if "batch" in t:          # the CPU tests' smaller batches
        cfg = override(override(cfg, "train.global_batch_size", t["batch"]),
                       "train.crop_samples", t["crop"])
        B, crop = t["batch"], t["crop"]
    weights = params.make_weights(params.teacher_spec(z), s_w, ctx.device,
                                  ctx.config["init"])
    model = TeacherWaveNet(cfg, stack_mode=resolve_stack_mode(
        cfg.teacher.fused_layers, "train"), device=ctx.device)
    model.load_state_dict(weights, strict=True)
    state = create_train_state(dict(model.named_parameters()), cfg.train)
    names = list(state.params)
    step_fn = make_teacher_train_step(model, cfg)
    _, it = make_train_stream(cfg, None, build_dataset(cfg, None), B, 0)
    batches = prefetch(it, put=device_put(ctx.device))

    def half(step):           # fault: half the batch, the mean of the rest
        return lambda s, wav: step(s, wav[: wav.shape[0] // 2])

    def frozen(orig):         # fault: a step that leaves the state as it is
        def apply(self, grads):
            self.step += 1
            return self
        return apply

    holder = _Holder(step_fn)
    faults = {"half": lambda: common.patched(holder, "fn", half),
              "state": lambda: common.patched(
                  TrainState, "apply_gradients", frozen)}
    n_check = t["checked_steps"]
    with common.fault(ctx, faults):
        losses = []
        first_grad = None
        for k in range(n_check):
            state, m = holder.fn(state, next(batches))
            losses.append(m["loss"].detach().clone())
            if k == 0:
                b1 = tr["adam_b1"]
                first_grad = {n: (mu / (1 - b1)).clone() for n, mu in
                              zip(names, state.opt_state.mu)}
        after = {n: p.detach().clone() for n, p in state.params.items()}
        for _ in range(t["warm_steps"]):
            state, m = holder.fn(state, next(batches))
        spans = []
        if ctx.trace:         # the host work's spans, with no profiler on
            ctx.sync()
            begin = time.perf_counter()
            while time.perf_counter() < begin + t["dispatch_seconds"]:
                t0 = time.perf_counter()
                state, m = holder.fn(state, next(batches))
                spans.append(time.perf_counter() - t0)
            ctx.sync()
            untraced_s = time.perf_counter() - begin
        ctx.sync()
        before = common.launch_counts()
        steps = 0
        with ctx.window() as win:
            while win.running():
                t0 = time.perf_counter()
                state, m = holder.fn(state, next(batches))
                if not ctx.trace:
                    spans.append(time.perf_counter() - t0)
                steps += 1
    elapsed = win.elapsed_s
    batches.close()
    launches = common.launches_since(before)
    ctx.read_memory()
    got = {"loss": [float(x) for x in losses],
           "grad": {n: float(g.double().norm()) for n, g in first_grad.items()},
           "g1": {n: first_grad[n] for n in names},
           "delta": {n: float((after[n] - weights[n]).double().norm())
                     for n in names}}
    del model, state, step_fn, holder, batches, after, m
    ctx.free()

    ref.no_tf32()
    raw = [torch.from_numpy(b).to(ctx.device) for b in traffic_gen.tone_batches(
        stream_seed, n_check, B, crop, dsp["sample_rate"])]
    truth = follow(raw, weights, names, z, dsp, tr, "fp32", t["check_rows"])
    cand = (follow(raw, weights, names, z, dsp, tr, "fp8", t["check_rows"])
            if ctx.candidate == "fp8" else got)
    checks = compare(cand, truth)
    samples = steps * B * crop
    out = Outcome(
        e2e={"train_utt_per_s": steps * B / elapsed},
        attempted=steps, failed=0, checks=checks,
        counts={"samples": samples, "steps": steps,
                "samples_per_step": B * crop},
        spans={"train_step": spans},
        notes={"launches": launches, "steps": steps,
               "losses": got["loss"], "reference_losses": truth["loss"]})
    if ctx.trace:
        out.counts.update(untraced_steps=len(spans), untraced_s=untraced_s)
        # what the profiler costs the step rate
        out.notes["utt_per_s_untraced_traced"] = [
            len(spans) * B / untraced_s, steps * B / elapsed]
    return out, win.trace


class _Holder:
    """The step the run calls, replaceable by a fault."""

    def __init__(self, fn):
        self.fn = fn


def follow(raw, weights, names, sizes, dsp, train, prec, rows) -> dict:
    """The reference's first steps from the benchmark's weights on the
    batches `raw`: losses, the first clipped gradient (its norm by leaf,
    and whole), the parameters' change after the last step by leaf."""
    import torch

    p = {n: w.clone() for n, w in weights.items()}
    state: dict = {}
    losses, first = [], None
    for k, wav in enumerate(raw):
        loss, grads = ref.teacher_loss_and_grads(wav, p, names, sizes, dsp,
                                                 prec, rows)
        clipped = ref.clipped_adam(p, grads, state, train)
        losses.append(loss)
        if k == 0:
            first = {n: float(g.double().norm()) for n, g in clipped.items()}
            g1 = clipped
    return {"loss": losses, "grad": first, "g1": g1,
            "delta": {n: float((p[n] - weights[n]).double().norm())
                      for n in names}}


def _worst_leaf(cand: dict, truth: dict, keep) -> float:
    scale = float(np.median([truth[n] for n in keep]))
    return max(abs(cand[n] - truth[n]) / max(truth[n], scale, 1e-30)
               for n in keep)


def _dir_gap(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    norms = float(a.norm() * b.norm())
    return 1.0 - float(a @ b) / norms if norms > 0 else 1.0


def compare(cand: dict, truth: dict) -> dict:
    """The numbers compared, each by its worst leaf: the gap of the first
    gradient's norms, the first gradient's direction (one minus the cosine
    of the leaf's gradient with the reference's: a step over part of the
    batch turns the data-dependent leaves, the upsampler's and the
    conditioning's, while their norms barely move), and the gap of the
    parameters' change's norms.  Leaves whose reference gradient is nought
    to rounding are left out of the direction and the change."""
    med = float(np.median(list(truth["grad"].values())))
    moved = [n for n, g in truth["grad"].items() if g >= NOUGHT * med]
    return {
        "grad_gap": _worst_leaf(cand["grad"], truth["grad"],
                                list(truth["grad"])),
        "grad_dir_gap": max(_dir_gap(cand["g1"][n], truth["g1"][n])
                            for n in moved),
        "update_gap": _worst_leaf(cand["delta"], truth["delta"], moved),
    }
