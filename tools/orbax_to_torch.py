#!/usr/bin/env python3
"""Convert a JAX training workdir's orbax checkpoints into the PyTorch
port's checkpoint format, so that a teacher trained by `pwn_tpu` can be
distilled, or a student vocoded, by `python -m pwn_tpu_torch.cli`.

For each of `ckpt_teacher/` and `ckpt_student/` present in the source
workdir, every retained step is restored through `pwn_tpu`'s own
`abstract_state_template` and `CheckpointManager` (JAX on the CPU), and
written to `<out>/ckpt_<tag>/<step>/state.pt` by the port's
`utils/checkpoint.py`: the parameters and EMA parameters (through
`convert.params_from_flax`), the step, and Adam's `mu`, `nu` and `count`
from the optax chain state.  The JAX state's random key has no
counterpart: the port's step noise is seeded from an integer, set here as
the port's loops set it (`train.seed` for the teacher, `train.seed + 2`
for the student).

Run from the repository root, with the case and overrides the source was
trained with:

    python3 tools/orbax_to_torch.py <case> --workdir SRC --out DST [k=v ...]

The port itself never imports this tool (the machine with the card has no
JAX).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pwn_tpu import config as jax_config  # noqa: E402
from pwn_tpu.training.loop import abstract_state_template  # noqa: E402
from pwn_tpu.utils.checkpoint import CheckpointManager as OrbaxManager  # noqa: E402
from pwn_tpu_torch import convert  # noqa: E402
from pwn_tpu_torch.training.common import (AdamState, ClippedAdam,  # noqa: E402
                                           TrainState)
from pwn_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402

# the port's step-noise seed of each run, over train.seed (training/loop.py)
SEED_OFFSET = {"teacher": 0, "student": 2}


def _adam_state(opt_state):
    """The optax chain's ScaleByAdamState (count, mu, nu)."""
    for node in jax.tree.leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu") and hasattr(n, "nu")):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
    raise ValueError("no Adam state in the checkpoint's optimizer state")


def port_state(state, tag: str, train_cfg) -> TrainState:
    """A restored JAX TrainState as the port's TrainState (host tensors)."""
    params = convert.params_from_flax(jax.device_get(state.params))
    adam = _adam_state(state.opt_state)
    mu = convert.params_from_flax(jax.device_get(adam.mu))
    nu = convert.params_from_flax(jax.device_get(adam.nu))
    ema = (None if state.ema_params is None
           else convert.params_from_flax(jax.device_get(state.ema_params)))
    return TrainState(
        params=params, tx=ClippedAdam(train_cfg),
        opt_state=AdamState(int(adam.count), [mu[k] for k in params],
                            [nu[k] for k in params]),
        step=int(state.step), seed=train_cfg.seed + SEED_OFFSET[tag],
        ema_params=ema)


def convert_workdir(cfg, src: str, out: str) -> dict:
    """Every retained step of `src`'s teacher and student checkpoints into
    `out`; returns {tag: [steps]}."""
    done = {}
    for tag in ("teacher", "student"):
        src_dir = os.path.join(os.path.abspath(src), f"ckpt_{tag}")
        if not os.path.isdir(src_dir):
            continue
        mngr = OrbaxManager(src_dir)
        steps = mngr.all_steps()
        template = abstract_state_template(cfg, tag)
        dst = CheckpointManager(os.path.join(out, f"ckpt_{tag}"),
                                max_to_keep=max(len(steps), 1))
        for step in steps:
            state, _ = mngr.restore(template, step=step)
            dst.save(step, port_state(state, tag, cfg.train))
            dst.wait()
            print(f"[orbax_to_torch] {tag} step {step} -> "
                  f"{os.path.join(dst.directory, str(step))}")
        mngr.close()
        done[tag] = steps
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case")
    ap.add_argument("--workdir", required=True,
                    help="the JAX run's workdir (holds ckpt_teacher/ or "
                         "ckpt_student/)")
    ap.add_argument("--out", required=True,
                    help="the port's workdir to write")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    overrides = dict(p.split("=", 1) for p in args.overrides)
    cfg = jax_config.get_config(args.case, **overrides)
    done = convert_workdir(cfg, args.workdir, args.out)
    if not done:
        print(f"no ckpt_teacher/ or ckpt_student/ under {args.workdir}",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
