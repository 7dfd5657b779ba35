"""Optimizer and train state (counterpart of `pwn_tpu/training/common.py`).

The reference's optimizer is
`optax.chain(clip_by_global_norm(clip), adam(exponential_decay(...)))`.
`ClippedAdam` takes the same steps:
  * clipping scales by max_norm / norm only when norm >= max_norm, with no
    epsilon (unlike `torch.nn.utils.clip_grad_norm_`);
  * Adam with b1, b2, eps = 1e-8, eps_root = 0 and bias correction;
  * the learning rate is lr * rate ** (count / decay_steps), smooth, on
    the count of updates before this one: the first step uses lr itself.
Parameters are updated in place under no_grad, which bumps each tensor's
`_version` (WaveNetStack's weight-layout cache keys on it).

Data parallelism: `average_across_processes` averages a step's gradients
and metrics over the process group in one all-reduce, the reference's
`pmean` over the mesh; clipping and `grad_norm` then see the averaged
gradients, as in the reference.

The model axis: a TrainState sharded by `parallel/tp.py::shard_state`
holds only this rank's slice of every gate tensor (the parameter, Adam's
`mu` and `nu`, the EMA) and the other tensors whole.  `apply_gradients`
clips by the norm of the full averaged gradient, runs Adam on the slices
and the whole tensors (Adam is elementwise, so a slice's update is the
same as its part of the whole tensor's), then rebuilds the model's gate
tensors from every rank's slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pwn_tpu_torch.config import TrainConfig
from pwn_tpu_torch.parallel.mesh import process_index

EPS = 1e-8


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@dataclass
class AdamState:
    count: int                # updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class ClippedAdam:
    """Global-norm clipping, then Adam on an exponentially decaying learning
    rate (see the module docstring)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def learning_rate(self, count: int) -> float:
        c = self.cfg
        return c.learning_rate * c.lr_decay_rate ** (count / c.lr_decay_steps)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState,
               norm: Optional[torch.Tensor] = None) -> None:
        """Clip `grads` by `norm`, the global norm of the whole gradient
        (default: `grads`' own; a sharded state passes the norm of the
        gradient it took its slices from), then one Adam step on `params`
        in place."""
        c = self.cfg
        if norm is None:
            norm = global_norm(grads)
        keep = norm < c.grad_clip_norm
        grads = [torch.where(keep, g, g / norm * c.grad_clip_norm)
                 for g in grads]
        b1, b2 = c.adam_b1, c.adam_b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - b2)
        lr = self.learning_rate(state.count)
        state.count += 1
        denom = torch._foreach_div(state.nu, 1 - b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(state.mu, 1 - b1 ** state.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


@dataclass
class TrainState:
    """The parameters being trained (the model's own tensors, updated in
    place), the optimizer and its state, the step, the seed of the step's
    generator (for stochastic losses), and the EMA copy when
    `train.ema_decay` > 0 (else None)."""

    params: Dict[str, torch.Tensor]
    tx: ClippedAdam
    opt_state: AdamState
    step: int = 0
    seed: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = field(default=None)

    # a `parallel/tp.py::ModelShard` when the gate tensors are sharded
    shard: Optional[object] = field(default=None)

    def trainable(self) -> List[torch.Tensor]:
        """The model's parameters in `params`' order: what a step
        differentiates (under a shard, the model's whole gate tensors in
        place of this rank's slices)."""
        if self.shard is None:
            return list(self.params.values())
        return [self.shard.full.get(k, p) for k, p in self.params.items()]

    def apply_gradients(self, grads: List[torch.Tensor]) -> "TrainState":
        """One clipped Adam update from the gradients of `trainable()`."""
        norm = global_norm(grads)
        if self.shard is not None:
            grads = [self.shard.local(k, g) for k, g in zip(self.params, grads)]
        self.tx.update(list(self.params.values()), grads, self.opt_state,
                       norm)
        if self.shard is not None:
            self.shard.sync_model(self.params)
        self.step += 1
        return self


def create_train_state(params: Dict[str, torch.Tensor], cfg: TrainConfig,
                       seed: Optional[int] = None) -> TrainState:
    tx = ClippedAdam(cfg)
    return TrainState(
        params=params, tx=tx, opt_state=tx.init(list(params.values())),
        seed=cfg.seed if seed is None else seed,
        ema_params=({k: p.detach().float().clone() for k, p in params.items()}
                    if cfg.ema_decay > 0 else None),
    )


@torch.no_grad()
def update_ema(state: TrainState, decay: float) -> TrainState:
    """ema <- ema * decay + params * (1 - decay)."""
    ema = list(state.ema_params.values())
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.float() for p in state.params.values()],
                        alpha=1.0 - decay)
    return state


def serving_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The params a consumer should run: the EMA when it is tracked."""
    return state.params if state.ema_params is None else state.ema_params


def step_generator(seed: int, step: int, device,
                   rank: Optional[int] = None) -> torch.Generator:
    """The noise generator of one training step on `device`, seeded from
    (seed, step, rank) alone, as the reference folds the step and the data
    shard's index into its key: a step's noise does not depend on what
    ran before it, and each process draws its own.  `rank` defaults to
    this process's; rank 0's seed is seed * 2^32 + step, the seed of a
    run without a process group."""
    rank = process_index() if rank is None else rank
    key = seed * 2 ** 32 + step
    if rank:
        key = int(np.random.SeedSequence([key, rank]).generate_state(
            1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key)


def averages_natively(device) -> bool:
    """Whether the process group's backend for `device`'s tensors has an
    average reduction: NCCL has; Gloo (on the CPU, and carrying CUDA
    tensors too) gets a sum divided by the world size."""
    pairs = dict(p.split(":") for p in dist.get_backend_config().split(",")
                 if ":" in p)
    return pairs.get(torch.device(device).type) == dist.Backend.NCCL


def average_across_processes(
        grads: List[torch.Tensor], metrics: Dict[str, torch.Tensor],
) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """(grads, metrics) averaged over the process group: every tensor
    flattened into one fp32 buffer on the gradients' device and averaged
    by one all-reduce (`averages_natively` picks the backend's average or
    a sum and a division).  Without a process group they come back as they
    are.  Every process calls it at the same step with tensors of the same
    shapes and the same metric keys."""
    if not dist.is_initialized():
        return grads, metrics
    names = list(metrics)
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [metrics[k].reshape(1).float() for k in names])
    if averages_natively(flat.device):
        dist.all_reduce(flat, op=dist.ReduceOp.AVG)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= dist.get_world_size()
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
        i += g.numel()
    return out, {k: flat[i + j] for j, k in enumerate(names)}
