"""The benchmark's weights: which tensors a model of a configuration has
(names, shapes, fan-in), and their values, drawn on the device from the
seed in a few large calls.

Names and shapes are the program's parameter interface (its state dict,
channels last: `front.kernel (1, 1, C)`, `layer_i.w_dilated (2, C, G)`,
`upsample.kernel_i (K, Cin, Cout)`); the benchmark loads the dict with
`load_state_dict(strict=True)` and hands a copy to the reference.
Kernels are fan-in scaled truncated normals (the initialisation of the
published models' code), biases truncated normals of std bias_std, so
that a path that drops a bias shows in the check; each stack's output
layer is then scaled as the configuration's `init` says
(`shape_outputs`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated at +-2


def _stack_spec(pre: str, C: int, G: int, S: int, M: int, L: int, out: int):
    spec = [(pre + "front.kernel", (1, 1, C), 1),
            (pre + "front.bias", (C,), None)]
    for l in range(L):
        lp = f"{pre}layer_{l}."
        spec += [(lp + "w_dilated", (2, C, G), 2 * C),
                 (lp + "b_dilated", (G,), None),
                 (lp + "w_cond", (M, G), M), (lp + "b_cond", (G,), None),
                 (lp + "w_res", (G // 2, C), G // 2),
                 (lp + "b_res", (C,), None),
                 (lp + "w_skip", (G // 2, S), G // 2),
                 (lp + "b_skip", (S,), None)]
    return spec + [(pre + "head1.kernel", (1, S, S), S),
                   (pre + "head1.bias", (S,), None),
                   (pre + "head2.kernel", (1, S, out), S),
                   (pre + "head2.bias", (out,), None)]


def _upsample_spec(strides, mult: int, M: int):
    return [s for i, st in enumerate(strides) for s in (
        (f"upsample.kernel_{i}", (st * mult, M, M), st * mult * M),
        (f"upsample.bias_{i}", (M,), None))]


def student_spec(sizes: dict):
    """(name, shape, fan-in or None for a bias) of a student IAF."""
    spec = _upsample_spec(sizes["upsample_strides"],
                          sizes["upsample_kernel_mult"], sizes["n_mels"])
    for i in range(sizes["n_flows"]):
        spec += _stack_spec(f"flow_{i}.", sizes["residual_channels"],
                            sizes["gate_channels"], sizes["skip_channels"],
                            sizes["n_mels"], sizes["layers_per_flow"], 2)
    return spec


def teacher_spec(sizes: dict):
    """(name, shape, fan-in or None) of a teacher WaveNet (MoL head)."""
    return _upsample_spec(sizes["upsample_strides"],
                          sizes["upsample_kernel_mult"],
                          sizes["n_mels"]) + _stack_spec(
        "stack.", sizes["residual_channels"], sizes["gate_channels"],
        sizes["skip_channels"], sizes["n_mels"], len(sizes["dilations"]),
        3 * sizes["n_mixtures"])


def make_weights(spec, seed: int, device, init: dict) -> dict:
    """float32 tensors on `device` from one truncated-normal draw and one
    scaling: kernel entries of std sqrt(1/fan_in), biases of std
    `init["bias_std"]`, each truncated at 2 std; then `shape_outputs`."""
    bias_std = init["bias_std"]
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    std = np.repeat([bias_std / _TRUNC_STD if fan is None
                     else math.sqrt(1.0 / fan) / _TRUNC_STD
                     for _, _, fan in spec], sizes).astype(np.float32)
    flat.mul_(torch.from_numpy(std).to(device))
    return shape_outputs({name: t.view(shape) for (name, shape, _), t in
                          zip(spec, torch.split(flat, sizes))}, init)


def shape_outputs(weights: dict, init: dict) -> dict:
    """The output 1x1 of each stack in `init["outputs"]` scaled by
    `init["out_scale"]` and its bias set to `init["out_bias"]` (one value a
    channel), so that random weights give audio of a speech-like level:
    unclipped, with no offset that the deemphasis filter would carry past
    full scale."""
    for pre in init.get("outputs", []):
        k, b = weights[pre + ".kernel"], weights[pre + ".bias"]
        k.mul_(init["out_scale"])
        b.copy_(torch.tensor(init["out_bias"], dtype=b.dtype))
    return weights
