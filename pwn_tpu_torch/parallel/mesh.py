"""The process grid (counterpart of `pwn_tpu/parallel/mesh.py` and of
`pwn_tpu/data/pipeline.py::local_batch_size`).

One process per card, launched by `torchrun` (or any launcher that sets
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`):

    torchrun --nproc-per-node 8 -m pwn_tpu_torch.cli train-teacher ...

`ensure_distributed` joins the process group: NCCL for CUDA tensors, Gloo
for CPU tensors.  Each process reads its partition of the corpus, takes
the global batch divided by the world size, and averages its gradients
and metrics with the others' once a step
(`training/common.py::average_across_processes`), the reference's `pmean`
over the mesh.  Without a process group the process is a world of one
and nothing here communicates.

The mesh `data x model` lays the world out as the reference lays its
devices out, the model axis innermost: rank = data_index * model +
model_index (`process_grid`).  Every rank still computes on its own rows
of the batch; the model axis shards the training state's gate tensors
over the ranks of one model group (`parallel/tp.py`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from pwn_tpu_torch.config import MeshConfig


def launcher_rank() -> int:
    """`LOCAL_RANK` from the launcher's environment (0 without one): the
    index of this process's card on its host."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def ensure_distributed(device: torch.device) -> None:
    """Join the process group the launcher describes, once; a no-op
    without a launcher (no `WORLD_SIZE` in the environment) or when the
    group exists.  `device` is the run's device: a CUDA one (set with
    `torch.cuda.set_device` before any CUDA work, as `utils/platform.
    require_cuda` does) joins with NCCL for CUDA tensors and Gloo for CPU
    ones, the CPU with Gloo only.  A launcher of one process makes a
    one-rank group."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    device = torch.device(device)
    if device.type == "cuda":
        backend = "cpu:gloo,cuda:nccl"
        torch.cuda.set_device(device)
    else:
        backend = "gloo"
    dist.init_process_group(backend=backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_size(global_batch: int) -> int:
    """This process's share of the global batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def mesh_shape(cfg: MeshConfig) -> tuple[int, int]:
    """(data, model) of `cfg` over this world: data = -1 takes the world
    divided by the model axis.  ValueError when the processes cannot form
    the mesh: each process holds one card, so data x model must be the
    world size."""
    n = process_count()
    model = max(1, cfg.model)
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    data = cfg.data if cfg.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover {n} devices")
    return data, model


@dataclass(frozen=True)
class ProcessGrid:
    """This rank's place on the `data x model` mesh, and the two subgroups
    it belongs to: the ranks of its model group share one data index (they
    hold one sharded state between them), those of its data group one
    model index.  The groups are None where the axis is 1 or there is no
    process group."""

    data: int
    model: int
    data_index: int
    model_index: int
    model_group: Optional[object] = None
    data_group: Optional[object] = None


_GRIDS: dict = {}


def process_grid(cfg: MeshConfig) -> ProcessGrid:
    """The grid of `cfg` over this world.  Its subgroups are made once per
    mesh shape and process group (`dist.new_group` is collective: every
    rank makes every group, in the same order), the model axis
    innermost."""
    data, model = mesh_shape(cfg)
    rank = process_index()
    if not dist.is_initialized():
        return ProcessGrid(data, model, rank // model, rank % model)
    key = (dist.group.WORLD, data, model)
    if key not in _GRIDS:
        model_groups = [dist.new_group([d * model + m for m in range(model)])
                        for d in range(data)]
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        _GRIDS[key] = (model_groups, data_groups)
    model_groups, data_groups = _GRIDS[key]
    d, m = rank // model, rank % model
    return ProcessGrid(data, model, d, m,
                       model_groups[d] if model > 1 else None,
                       data_groups[m] if data > 1 else None)


def barrier(device: torch.device) -> None:
    """Wait for every process (a no-op without a group)."""
    if not dist.is_initialized():
        return
    if torch.device(device).type == "cuda":
        dist.barrier(device_ids=[torch.device(device).index])
    else:
        dist.barrier()


def broadcast_int(value: int) -> int:
    """Rank 0's `value`, on every rank (itself without a group)."""
    if not dist.is_initialized():
        return value
    obj = [value]
    dist.broadcast_object_list(obj, src=0)
    return obj[0]
