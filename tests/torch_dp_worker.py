"""One process of the port's data-parallel tests
(tests/test_torch_distributed.py), started with a launcher's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), on the CPU:

    python tests/torch_dp_worker.py MODE OUT CONFIG_JSON [ARGS...]

MODE is "grads" (one gradient of half the batch in OUT/batch.npy, the
parameters OUT/params.pt, averaged across processes), "loop"
(`run_teacher_training` with a workdir and a data dir: the batches each
step got, the final parameters and metrics, and every file this process
created, renamed or removed under the workdir) or "world1" (the teacher
and distillation loops without a process group, then in one).  CONFIG_JSON
holds `key=value` overrides of tiny_teacher.  Each process writes
OUT/<mode>_<rank>.pt.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pwn_tpu_torch import get_config, override  # noqa: E402
from pwn_tpu_torch.models.teacher import (  # noqa: E402
    TeacherWaveNet, init_teacher)
from pwn_tpu_torch.parallel.mesh import (  # noqa: E402
    ensure_distributed, process_index)
from pwn_tpu_torch.training import loop  # noqa: E402
from pwn_tpu_torch.training.common import (  # noqa: E402
    average_across_processes, step_generator)
from pwn_tpu_torch.training.teacher import prepare_batch  # noqa: E402


def _config(overrides: dict):
    cfg = get_config("tiny_teacher")
    for k, v in overrides.items():
        cfg = override(cfg, k, v)
    return cfg


def _grads(cfg, out):
    ensure_distributed(torch.device("cpu"))
    rank = process_index()
    wav = np.load(os.path.join(out, "batch.npy"))
    half = len(wav) // 2
    model = TeacherWaveNet(cfg, stack_mode="train")
    model.load_state_dict(torch.load(os.path.join(out, "params.pt"),
                                     weights_only=True))
    names, params = zip(*model.named_parameters())
    loss = model.loss(*prepare_batch(
        torch.from_numpy(wav[rank * half:(rank + 1) * half]), cfg))
    grads = torch.autograd.grad(loss, params)
    grads, metrics = average_across_processes(list(grads),
                                              {"loss": loss.detach()})
    noise = torch.rand(8, generator=step_generator(5, 3, "cpu"))
    return {"grads": dict(zip(names, grads)), "loss": metrics["loss"],
            "noise": noise}


def _writes_under(root: str, log: list):
    """An audit hook that logs every file this process opens for writing,
    and every directory it makes (one not there yet), renames or removes,
    under `root`."""
    root = os.path.abspath(root)
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def under(path) -> bool:
        if isinstance(path, bytes):
            path = path.decode()
        return (isinstance(path, (str, os.PathLike))
                and os.path.abspath(path).startswith(root))

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            if (any(c in (mode or "") for c in "wax+")
                    or (mode is None and flags & write_flags)) and under(path):
                log.append((event, str(path)))
        elif event == "os.mkdir" and under(args[0]):
            if not os.path.exists(args[0]):
                log.append((event, str(args[0])))
        elif event in ("os.rename", "os.remove", "os.rmdir",
                       "shutil.rmtree") and under(args[0]):
            log.append((event, str(args[0])))

    sys.addaudithook(hook)


def _loop(cfg, out, workdir, data_dir, num_steps):
    writes: list = []
    _writes_under(workdir, writes)
    seen = []
    prefetch = loop.prefetch

    def tap(it, put, depth=2):
        def record(batch):
            seen.append(batch.copy())
            return put(batch)

        return prefetch(it, record, depth)

    loop.prefetch = tap
    ensure_distributed(torch.device("cpu"))
    res = loop.run_teacher_training(cfg, workdir, data_dir,
                                    num_steps=int(num_steps), device="cpu")
    return {"batches": np.stack(seen[:res.steps_run]),
            "params": {k: v.detach().clone()
                       for k, v in res.state.params.items()},
            "metrics": res.final_metrics, "steps_run": res.steps_run,
            "writes": writes}


def _world1(cfg, out, data_dir):
    teacher = init_teacher(cfg, torch.Generator().manual_seed(0),
                           device="cpu").state_dict()

    def runs():
        t = loop.run_teacher_training(cfg, None, data_dir, num_steps=2,
                                      device="cpu")
        d = loop.run_distillation(cfg, teacher, None, data_dir, num_steps=2,
                                  device="cpu")
        return ({k: v.detach().clone() for k, v in t.state.params.items()},
                {k: v.detach().clone() for k, v in d.state.params.items()},
                t.final_metrics, d.final_metrics)

    alone = runs()
    ensure_distributed(torch.device("cpu"))
    import torch.distributed as dist

    assert dist.is_initialized() and dist.get_world_size() == 1
    return {"alone": alone, "group": runs()}


def main(mode, out, config_json, *args):
    torch.set_num_threads(1)
    cfg = _config(json.loads(config_json))
    fn = {"grads": _grads, "loop": _loop, "world1": _world1}[mode]
    result = fn(cfg, out, *args)
    torch.save(result, os.path.join(out, f"{mode}_{process_index()}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:])
