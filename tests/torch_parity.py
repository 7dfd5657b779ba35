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
