"""Data parallelism across processes (counterpart of the data axis of
`pwn_tpu/parallel/mesh.py` and of `pwn_tpu/data/pipeline.py::
local_batch_size`).

One process per card, launched by `torchrun` (or any launcher that sets
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`):

    torchrun --nproc-per-node 8 -m pwn_tpu_torch.cli train-teacher ...

`ensure_distributed` joins the process group: NCCL for CUDA tensors, Gloo
for CPU tensors.  Each process reads its partition of the corpus, takes
the global batch divided by the world size, and averages its gradients
and metrics with the others' once a step
(`training/common.py::average_across_processes`), the reference's `pmean`
over the data axis.  Without a process group the process is a world of
one and nothing here communicates.  The model axis (tensor parallelism)
is not ported.
"""

from __future__ import annotations

import os

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


def check_mesh(cfg: MeshConfig) -> None:
    """Refuse a mesh the processes cannot form: one card per process, so
    the data axis is the world size (-1: whatever it is), and the model
    axis is 1."""
    if cfg.model > 1:
        raise NotImplementedError(
            f"mesh.model={cfg.model}: tensor parallelism is not ported yet "
            "(the tensor-parallel slice)")
    n = process_count()
    if cfg.data > 0 and cfg.data != n:
        raise ValueError(f"mesh {cfg.data}x{max(1, cfg.model)} does not "
                         f"cover {n} devices")


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
