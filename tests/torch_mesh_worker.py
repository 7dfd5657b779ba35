"""One process of the port's model-axis and sequence-parallel tests
(tests/test_torch_tp.py, tests/test_torch_sp.py), started with a
launcher's environment on the CPU (a Gloo group):

    python tests/torch_mesh_worker.py MODE OUT CONFIG_JSON

CONFIG_JSON holds `key=value` overrides of tiny_teacher.  MODE:

- "tp" (2 ranks): the teacher loop 3 steps on mesh 1 x 2 (workdir a) and
  on 2 x 1, 2 steps on 1 x 2 then resumed to 3 on 2 x 1 (workdir c),
  distillation 2 steps on each mesh; the slices this rank held and its
  state bytes; the averaging's backend choice; batch-sharded generation
  of OUT/mel.npy with OUT/params.pt, from a sharded state, and the
  refusal of a batch that does not divide.
- "tp4" (4 ranks): batch-sharded generation, and `dryrun_multichip(4)`.
- "sp" (2 or 4 ranks): both sequence-parallel paths on OUT/mel_sp.npy
  with OUT/params.pt, and their refusals.

Each process writes OUT/<mode>_<rank>.pt.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pwn_tpu_torch import get_config, override  # noqa: E402
from pwn_tpu_torch.models.student import StudentIAF  # noqa: E402
from pwn_tpu_torch.models.teacher import init_teacher  # noqa: E402
from pwn_tpu_torch.parallel import sp, tp  # noqa: E402
from pwn_tpu_torch.parallel.mesh import (  # noqa: E402
    ensure_distributed, process_count, process_grid, process_index)
from pwn_tpu_torch.training import loop  # noqa: E402
from pwn_tpu_torch.training.common import (  # noqa: E402
    average_across_processes, averages_natively, create_train_state)
from pwn_tpu_torch.utils.checkpoint import snapshot  # noqa: E402

SEED = 11


def _config(overrides: dict):
    cfg = get_config("tiny_teacher")
    for k, v in overrides.items():
        cfg = override(cfg, k, v)
    return cfg


def _mesh(cfg, data: int, model: int):
    return override(override(cfg, "mesh.data", data), "mesh.model", model)


def _student(cfg, out):
    model = StudentIAF(cfg)
    model.load_state_dict(torch.load(os.path.join(out, "params.pt"),
                                     weights_only=True))
    return model.eval()


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _whole(state) -> dict:
    """Host copies of the whole state (gathered over the model group)."""
    return snapshot(tp.gather_state(state))


def _tp(cfg, out):
    cpu = torch.device("cpu")
    res = {}
    a = loop.run_teacher_training(_mesh(cfg, 1, 2), os.path.join(out, "a"),
                                  num_steps=3, device=cpu)
    st = a.state
    res["slices"] = {
        k: [tuple(t.shape) for t in (st.params[k], mu, nu, st.ema_params[k])]
        + [t.untyped_storage().nbytes() for t in (st.params[k], mu, nu)]
        for k, mu, nu in zip(st.params, st.opt_state.mu, st.opt_state.nu)
        if k in st.shard.full}
    res["bytes_12"] = tp.state_bytes(st)
    res["teacher_12"] = _whole(st)
    res["model_12"] = {k: p.detach().clone()
                       for k, p in st.shard.full.items()}
    b = loop.run_teacher_training(_mesh(cfg, 2, 1), num_steps=3, device=cpu)
    res["bytes_21"] = tp.state_bytes(b.state)
    res["teacher_21"] = _whole(b.state)
    wc = os.path.join(out, "c")
    first = loop.run_teacher_training(_mesh(cfg, 1, 2), wc, num_steps=2,
                                      device=cpu)
    again = loop.run_teacher_training(_mesh(cfg, 2, 1), wc, num_steps=3,
                                      device=cpu)
    res["resume_steps"] = (first.steps_run, again.steps_run)
    res["resumed"] = _whole(again.state)
    teacher = init_teacher(cfg, torch.Generator().manual_seed(0),
                           device=cpu).state_dict()
    res["distill_12"] = _whole(loop.run_distillation(
        _mesh(cfg, 1, 2), teacher, num_steps=2, device=cpu).state)
    res["distill_21"] = _whole(loop.run_distillation(
        _mesh(cfg, 2, 1), teacher, num_steps=2, device=cpu).state)

    # the averaging on this Gloo group: sum and divide, for CUDA tensors too
    res["avg_native"] = (averages_natively(torch.device("cuda")),
                         averages_natively(cpu))
    g, m = average_across_processes(
        [torch.full((3,), float(process_index() + 1))],
        {"x": torch.tensor(float(3 * process_index()))})
    res["avg"] = (g[0], m["x"])

    # batch-sharded generation: from the parameters, and from a state
    # sharded over the model axis into a model holding other ones
    mel = torch.from_numpy(np.load(os.path.join(out, "mel.npy")))
    gen = tp.make_batch_sharded_generate(cfg)
    model = _student(cfg, out)
    res["bs"] = gen(model, SEED, mel)
    grid = process_grid(_mesh(cfg, 1, 2).mesh)
    state = tp.shard_state(create_train_state(
        {k: p.detach().clone() for k, p in model.named_parameters()},
        override(cfg, "train.ema_decay", 0.9).train), grid)
    res["bs_state"] = gen(StudentIAF(cfg).eval(), SEED, mel, state=state)
    res["bs_refusal"] = _refusal(lambda: gen(model, SEED, mel[:3]))
    return res


def _tp4(cfg, out):
    from pwn_tpu_torch.dryrun import dryrun_multichip

    mel = torch.from_numpy(np.load(os.path.join(out, "mel.npy")))
    res = {"bs": tp.make_batch_sharded_generate(cfg)(_student(cfg, out), SEED,
                                                      mel)}
    res["dryrun"] = dryrun_multichip(4, device="cpu")
    return res


def _sp(cfg, out):
    n, rank = process_count(), process_index()
    mel = torch.from_numpy(np.load(os.path.join(out, "mel_sp.npy")))
    model = _student(cfg, out)
    res = {"mega": sp.make_sp_generate_mega(cfg)(model, SEED, mel),
           "halo": sp.make_sp_generate(cfg)(
               model, SEED, sp.shard_mel_time(mel, rank, n))}
    big = get_config("tiny_teacher")  # dilations to 512
    m = cfg.dsp.n_mels
    res["refusals"] = {
        "max dilation": _refusal(lambda: sp.make_sp_generate(big)(
            model, SEED, torch.zeros(1, 4 // n, m))),
        "halo divisible": _refusal(lambda: sp.validate_sp(big, n, 4 * n + 1)),
        "overlap": _refusal(lambda: sp.make_sp_generate_mega(cfg)(
            model, SEED, torch.zeros(1, 4 * n, m))),
        "mega divisible": _refusal(
            lambda: sp.make_sp_generate_mega(cfg)(
                model, SEED, torch.zeros(1, 32 * n + 1, m)))}
    return res


def main(mode, out, config_json):
    torch.set_num_threads(1)
    cfg = _config(json.loads(config_json))
    ensure_distributed(torch.device("cpu"))
    result = {"tp": _tp, "tp4": _tp4, "sp": _sp}[mode](cfg, out)
    torch.save(result, os.path.join(out, f"{mode}_{process_index()}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:])
