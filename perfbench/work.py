"""Operation and byte counts of the functions the cells' layers compute,
and the card's data-sheet peaks, frozen here so that no change to the
program can move the yardstick.

The counts follow the function a layer computes at the sizes the traffic
asks for (true utterance lengths, not padded buckets), not the kernel
that computes it today: each input read once, each output written once;
a multiply-add is two operations.  The MAC model of the stack and the
upsampler is a copy of the program's `benchmarks.py`
(`_stack_macs_per_sample`, `_upsample_macs_per_sample`,
`student_gen_flops_per_sample`, `teacher_fwd_flops_per_sample`).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 CUDA cores,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
BF16, FP32 = 2, 4


def stack_macs_per_sample(C: int, G: int, S: int, M: int, L: int,
                          out_dim: int) -> float:
    """MACs per timestep of one WaveNet stack: front 1x1, L gated layers
    ([x | x_{t-d} | cond] @ W_in, z @ [W_res | W_skip]), the 1x1 head."""
    return (C + L * ((2 * C + M) * G + (G // 2) * (C + S))
            + S * S + S * out_dim)


def gated_layers_macs_per_sample(C: int, G: int, S: int, M: int,
                                 L: int) -> float:
    """MACs per timestep of the L gated layers alone (what kernels 1, 2 and
    5 compute)."""
    return L * ((2 * C + M) * G + (G // 2) * (C + S))


def upsample_macs_per_sample(strides, mult: int, M: int) -> float:
    """Transposed-conv upsampler MACs per output sample."""
    total = 0.0
    for i, s in enumerate(strides):
        after = 1
        for s2 in strides[i + 1:]:
            after *= s2
        total += (s * mult) * M * M / after
    return total


def student_flops_per_sample(z: dict) -> float:
    """Synthesis operations per audio sample: every flow's stack and the
    upsampler."""
    return 2.0 * (z["n_flows"] * stack_macs_per_sample(
        z["residual_channels"], z["gate_channels"], z["skip_channels"],
        z["n_mels"], z["layers_per_flow"], 2) + upsample_macs_per_sample(
        z["upsample_strides"], z["upsample_kernel_mult"], z["n_mels"]))


def teacher_fwd_flops_per_sample(z: dict) -> float:
    """Teacher forward operations per sample (stack with the MoL head, and
    the upsampler)."""
    return 2.0 * (stack_macs_per_sample(
        z["residual_channels"], z["gate_channels"], z["skip_channels"],
        z["n_mels"], len(z["dilations"]), 3 * z["n_mixtures"])
        + upsample_macs_per_sample(z["upsample_strides"],
                                   z["upsample_kernel_mult"], z["n_mels"]))


def gated_stack_fwd(C: int, G: int, S: int, M: int, L: int, samples: float,
                    save_inputs: bool = False) -> tuple:
    """(operations, bytes) of the gated layers' forward over `samples`
    timesteps in bf16: x and cond read, the skip sum written (and, for the
    training forward, each layer's input saved), the weights read once."""
    ops = 2.0 * gated_layers_macs_per_sample(C, G, S, M, L) * samples
    per = (C + M + S + (L * C if save_inputs else 0)) * BF16
    weights = L * ((2 * C + M) * G + (G // 2) * (C + S)) * BF16
    return ops, per * samples + weights


def gated_stack_bwd(C: int, G: int, S: int, M: int, L: int,
                    samples: float) -> tuple:
    """(operations, bytes) of the gated layers' backward with weight
    gradients over `samples` timesteps: the input and weight cotangents
    each cost the forward's products; each layer's saved input, cond and
    the skip cotangent read, dx and dcond written, the weights read and
    their fp32 gradients written once."""
    ops = 4.0 * gated_layers_macs_per_sample(C, G, S, M, L) * samples
    per = (L * C + M + S + C + M) * BF16
    n_w = L * ((2 * C + M) * G + (G // 2) * (C + S))
    return ops, per * samples + n_w * (BF16 + FP32)


def ar_step_flops(z: dict, rows: int) -> float:
    """Operations of one AR step of `rows` rows: the teacher stack and its
    head for one timestep (the upsampler runs once, outside the loop)."""
    return 2.0 * rows * stack_macs_per_sample(
        z["residual_channels"], z["gate_channels"], z["skip_channels"],
        z["n_mels"], len(z["dilations"]), 3 * z["n_mixtures"])


def least_time(ops: float, nbytes: float, peak_flops: float) -> float:
    """The least seconds the card could take: the larger of the operation
    and the byte bounds."""
    return max(ops / peak_flops, nbytes / PEAK_BYTES_PER_S)
