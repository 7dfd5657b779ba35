"""Helpers the drivers share: the program's launch counters (printed as
proof of the route a cell takes), the sample of answers the check reads,
and the gaps it compares."""

from __future__ import annotations

import contextlib

import numpy as np


def launch_counts() -> dict:
    """The program's kernel-launch counters, flattened."""
    from pwn_tpu_torch.ops import flow_stack as fs
    from pwn_tpu_torch.ops.ar_sampler import ar_sample
    from pwn_tpu_torch.ops.gated_layer import gated_layer

    out = {"kernel1": fs.flow_stack.launches,
           "kernel3": fs.flow_stack_train_backward.launches,
           "kernel4": ar_sample.launches,
           "kernel5": gated_layer.launches}
    for k, v in gated_layer.launches_by.items():
        out["kernel5." + ".".join(map(str, k))] = v
    for k, v in fs.flow_stack_train_backward.launches_by.items():
        out["kernel3." + ".".join(map(str, k))] = v
    for k, v in ar_sample.launches_by.items():
        out[f"kernel4.{k}"] = v
    return out


def launches_since(before: dict) -> dict:
    now = launch_counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


def pick(n: int, k: int, seed: int, must=()) -> list:
    """k distinct indices of range(n) drawn from the seed, with `must`."""
    rng = np.random.default_rng(seed)
    chosen = list(dict.fromkeys(int(i) for i in must))
    rest = [i for i in rng.permutation(n) if int(i) not in chosen]
    return chosen + [int(i) for i in rest[: max(0, k - len(chosen))]]


def max_abs(cand: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(np.asarray(cand, np.float64)
                               - np.asarray(ref, np.float64))))


def fault(ctx, faults: dict):
    """The fault `ctx.fault` planted in the program (a context manager
    from `faults`), or nothing."""
    if ctx.fault is None:
        return contextlib.nullcontext()
    if ctx.fault not in faults:
        raise ValueError(f"{ctx.workload} has no fault {ctx.fault!r}; "
                         f"one of {sorted(faults)}")
    return faults[ctx.fault]()


@contextlib.contextmanager
def patched(obj, name: str, make):
    """obj.name replaced by make(original) inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def alter_answer(orig):
    """A fault: the waveform each call produces changed at its middle
    sample by at least 0.9."""
    def fn(*args, **kwargs):
        import torch

        out = orig(*args, **kwargs).clone()
        mid = out.shape[-1] // 2
        out[..., mid] = torch.where(out[..., mid] > 0, -0.9, 0.9)
        return out
    return fn
