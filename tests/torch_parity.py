"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Each package keeps its own configuration: the port's tests build their
configs with `pwn_tpu_torch.config`, and hand the JAX package the field-
for-field equal `pwn_tpu.config.Config` that `jax_config` makes.
"""

import dataclasses


def jax_config(cfg):
    """The JAX package's Config with every field of the port's `cfg`."""
    from pwn_tpu import config as jc

    d = dataclasses.asdict(cfg)
    subs = {f.name: f.type for f in dataclasses.fields(jc.Config)
            if f.name != "name"}
    return jc.Config(name=d["name"], **{
        name: getattr(jc, cls if isinstance(cls, str) else cls.__name__)(
            **d[name]) for name, cls in subs.items()})


# a student small enough for the CPU streaming and serving tests:
# tiny_teacher's DSP with 2 flows x 3 layers at C=16 (R = 128 samples)
SMALL_STUDENT = {
    "student.n_flows": 2, "student.layers_per_flow": 3,
    "student.residual_channels": 16, "student.gate_channels": 32,
    "student.skip_channels": 16,
}


def paired_students(cfg, seed: int = 0, jitter: float = 0.05):
    """(JAX model, its params as numpy, the port's StudentIAF on the CPU
    with the same parameters), every parameter jittered by `jitter` times a
    unit normal: fresh inits have zero biases, which would hide an offset
    of the upsampler's conditioning."""
    import jax
    import numpy as np
    from pwn_tpu.config import override as jax_override
    from pwn_tpu.models.student import init_student

    from pwn_tpu_torch import convert
    from pwn_tpu_torch.models.student import StudentIAF

    jcfg = jax_override(jax_config(cfg), "student.fused_layers", "off")
    model, variables = init_student(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 99)
    params = jax.tree.map(
        lambda p: np.asarray(p) + jitter * rng.standard_normal(p.shape).astype(
            np.float32), variables["params"])
    port = StudentIAF(cfg)
    port.load_state_dict(convert.params_from_flax(params))
    return model, params, port.eval()


def launch_workers(worker: str, world: int, mode: str, out, config: dict,
                   *args, timeout: int = 120) -> list:
    """Start `world` processes of `python worker MODE OUT CONFIG_JSON
    ARGS...` with a launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT on a free port; no card, one OpenMP thread)
    in `out`, wait for them (killing them all past `timeout` seconds or on
    a failure), and return each rank's OUT/<mode>_<rank>.pt."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "CUDA_VISIBLE_DEVICES": "",
               "OMP_NUM_THREADS": "1"}
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, worker, mode, str(out), json.dumps(config),
             *map(str, args)], env=env, cwd=str(out),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n\n".join(logs)
    return [torch.load(Path(out) / f"{mode}_{r}.pt", weights_only=False)
            for r in range(world)]
