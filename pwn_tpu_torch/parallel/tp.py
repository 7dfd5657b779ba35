"""The model axis: gate-channel sharding of the training state, and
generation sharded over the batch (counterpart of
`pwn_tpu/parallel/tp.py`).

The sharding rules are the reference's, on the port's parameter names:
under a `layer_*` module (`models/modules.py::GatedLayer`)

    w_dilated (2, C, G)  split on axis 2
    w_cond    (M, G)     split on axis 1
    b_dilated, b_cond    split on axis 0
    w_res     (G/2, C)   split on axis 0
    w_skip    (G/2, S)   split on axis 0

and every other tensor is whole on every rank.  `validate_tp` keeps each
gate half divisible, so a rank's slice of G holds G/2n channels of each
half.

What the axis shards here is storage, which is what the reference keeps
it for ("TP state sharding remains available ... for storage",
`pwn_tpu/config.py`): `shard_state` leaves each rank of a model group only
its slice of every gate tensor's parameter, Adam moments and EMA.  The
compute runs on the whole weights through the existing kernels: after
each update one all_gather over the model group rebuilds the model's gate
tensors from the slices (`ModelShard.sync_model`).  A Megatron split of
the compute would need kernels at G/n and one (B, T, C+S) all-reduce per
layer, which the reference itself rates at 13.7 % efficiency and runs in
XLA; it is not done.

`make_batch_sharded_generate` is synthesis sharded over every rank: each
rank draws the same global noise, runs its B/n rows with the whole
weights, and all_gathers the rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.parallel.mesh import (ProcessGrid, process_count,
                                         process_index)
from pwn_tpu_torch.training.common import AdamState, TrainState

# the split axis of each gate tensor, by its trailing name
GATE_AXES = {"w_dilated": 2, "b_dilated": 0, "w_cond": 1, "b_cond": 0,
             "w_res": 0, "w_skip": 0}


def param_spec(name: str) -> Optional[int]:
    """The axis a parameter (a state-dict name) is split on over the model
    axis, or None where it is held whole."""
    parts = name.split(".")
    if parts[-1] in GATE_AXES and any(p.startswith("layer_")
                                      for p in parts[:-1]):
        return GATE_AXES[parts[-1]]
    return None


def validate_tp(gate_channels: int, model: int) -> None:
    """Refuse a model axis that does not divide each gate half."""
    if model > 1 and (gate_channels // 2) % model:
        raise ValueError(
            f"gate_channels/2 = {gate_channels // 2} must divide over "
            f"model axis {model}")


class ModelShard:
    """This rank's part of a training state sharded over its model group:
    `full` the model's whole gate tensors (by state name), which the
    compute reads, and the group that holds the other slices."""

    def __init__(self, grid: ProcessGrid, full: Dict[str, torch.Tensor]):
        self.index, self.size = grid.model_index, grid.model
        self.group = grid.model_group
        self.full = full
        self.axes = {k: param_spec(k) for k in full}

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a tensor of the state (a view; the tensor
        itself where `name` is held whole)."""
        axis = self.axes.get(name)
        if axis is None:
            return t
        n = t.shape[axis] // self.size
        return t.narrow(axis, self.index * n, n)

    def gather(self, items: Sequence[Tuple[str, torch.Tensor]]
               ) -> List[torch.Tensor]:
        """The whole tensors of `items` ((state name, this rank's slice)
        pairs, all of one dtype), by one all_gather over the model group of
        every slice flattened into one buffer."""
        flat = torch.cat([t.reshape(-1) for _, t in items])
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(parts, flat, group=self.group)
        out, i = [], 0
        for name, t in items:
            n = t.numel()
            out.append(torch.cat([p[i:i + n].view_as(t) for p in parts],
                                 dim=self.axes[name]))
            i += n
        return out

    @torch.no_grad()
    def sync_model(self, params: Dict[str, torch.Tensor]) -> None:
        """Rebuild the model's gate tensors from every rank's slices of
        `params`, in place (`copy_` bumps each tensor's version, which the
        kernels' packed weights key on; a `.data` write would not)."""
        names = list(self.full)
        for k, t in zip(names, self.gather([(k, params[k]) for k in names])):
            self.full[k].copy_(t)


def shard_state(state: TrainState, grid: ProcessGrid) -> TrainState:
    """`state` (whole, its params the model's own tensors) sharded over
    `grid`'s model axis: every gate tensor's parameter, Adam moments and
    EMA cut to this rank's slice (a copy: the whole moments and EMA are
    dropped with the old state), the other tensors shared as they are.
    A model axis of 1 returns `state`."""
    if grid.model == 1:
        return state
    full = {k: p for k, p in state.params.items() if param_spec(k) is not None}
    shard = ModelShard(grid, full)

    def cut(name: str, t: torch.Tensor) -> torch.Tensor:
        return shard.local(name, t).detach().clone() if name in full else t

    def cut_all(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [cut(k, t) for k, t in zip(state.params, ts)]

    return TrainState(
        params={k: cut(k, p) for k, p in state.params.items()},
        tx=state.tx,
        opt_state=AdamState(state.opt_state.count,
                            cut_all(state.opt_state.mu),
                            cut_all(state.opt_state.nu)),
        step=state.step, seed=state.seed,
        ema_params=(None if state.ema_params is None else
                    {k: cut(k, e) for k, e in state.ema_params.items()}),
        shard=shard)


def gather_state(state: TrainState) -> TrainState:
    """The whole state of a sharded one, on every rank of its model group
    (one all_gather of every slice; each rank calls it at the same step);
    the whole tensors shared, the gate tensors fresh.  An unsharded state
    comes back as it is."""
    shard = state.shard
    if shard is None:
        return state
    names = list(state.params)
    groups = [state.params, dict(zip(names, state.opt_state.mu)),
              dict(zip(names, state.opt_state.nu))]
    if state.ema_params is not None:
        groups.append(state.ema_params)
    whole = iter(shard.gather([(k, g[k]) for g in groups
                               for k in names if k in shard.full]))
    full = [{k: next(whole) if k in shard.full else g[k] for k in names}
            for g in groups]
    return TrainState(
        params=full[0], tx=state.tx,
        opt_state=AdamState(state.opt_state.count, list(full[1].values()),
                            list(full[2].values())),
        step=state.step, seed=state.seed,
        ema_params=full[3] if len(full) > 3 else None)


def state_bytes(state: TrainState) -> Dict[str, int]:
    """Bytes this rank's state holds: parameters, Adam's two moments, and
    the EMA (0 without one)."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    return {"params": nbytes(state.params.values()),
            "adam": nbytes(state.opt_state.mu) + nbytes(state.opt_state.nu),
            "ema": nbytes((state.ema_params or {}).values())}


def global_noise(cfg: Config, seed: int, shape, device,
                 temperature: float = 1.0) -> torch.Tensor:
    """The base noise of a sharded synthesis call, the same on every rank:
    `sample_base_noise` of the whole `shape` from a generator on `device`
    seeded with `seed`, times `temperature` (what the student's `generate`
    draws from that generator)."""
    from pwn_tpu_torch.models.student import sample_base_noise

    gen = torch.Generator(device=device).manual_seed(seed)
    return sample_base_noise(cfg, gen, shape) * temperature


def gather_along(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's `t` joined along `dim` in rank order (one all_gather
    over the whole group; `t` itself without one)."""
    if process_count() == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim)


def make_batch_sharded_generate(cfg: Config, temperature: float = 1.0):
    """`(model, seed, mel, state=None) -> wav (B, T)` on every rank, the
    batch split over every rank of the group (the counterpart of the
    reference's shard_map over ("data", "model")).  Each rank draws the
    global (B, T) noise (`global_noise`), takes its B/n rows and their
    mels, upsamples each row alone (as `generate.stream_window` does: a
    batch of another size rounds a row differently in cuDNN's bf16
    transposed convolutions, and a row must not depend on its neighbours),
    runs the flows with the whole weights, and all_gathers the rows.  With
    `state`, its serving parameters are gathered into `model` first.
    ValueError when B does not divide over the ranks."""

    @torch.no_grad()
    def generate(model, seed: int, mel, state: Optional[TrainState] = None):
        from pwn_tpu_torch.models.modules import match_length
        from pwn_tpu_torch.training.common import serving_params

        if state is not None:  # a collective over the model group
            model.load_state_dict(serving_params(gather_state(state)))
        n, rank = process_count(), process_index()
        device = next(model.parameters()).device
        mel = torch.as_tensor(mel, dtype=torch.float32, device=device)
        B = mel.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} devices")
        T = mel.shape[1] * cfg.dsp.hop_length
        z = global_noise(cfg, seed, (B, T), device, temperature)
        rows = slice(rank * (B // n), (rank + 1) * (B // n))
        cond = torch.cat([match_length(model.upsample_cond(m[None]), T)
                          for m in mel[rows]])
        return gather_along(model.flows_from_z(z[rows], cond), 0)

    return generate
