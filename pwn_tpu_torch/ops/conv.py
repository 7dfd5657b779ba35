"""Causal / dilated / transposed 1-D convolutions, channels-last
(counterpart of `pwn_tpu/ops/conv.py`).

Layout is `(batch, time, channels)` and kernels are `(K, Cin, Cout)`, as
in the reference, so parameters convert by copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shift_right(x: torch.Tensor, amount: int, axis: int = 1) -> torch.Tensor:
    """Shift along `axis` by `amount`, zero-filling at the start.

    shift_right(x, d)[..., t, :] == x[..., t-d, :]  (0 for t < d).
    """
    if amount == 0:
        return x
    T = x.shape[axis]
    if amount >= T:
        # receptive field longer than the sequence: everything is padding
        return torch.zeros_like(x)
    head = torch.zeros_like(x.narrow(axis, 0, amount))
    return torch.cat([head, x.narrow(axis, 0, T - amount)], dim=axis)


def causal_conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    dilation: int = 1,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal dilated conv: x (B, T, Cin), kernel (K, Cin, Cout) -> (B, T, Cout),
    for K = 1 and K = 2 (the WaveNet case): y[t] = x[t] @ W1 + x[t-d] @ W0."""
    k = kernel.shape[0]
    if k == 1:
        out = x @ kernel[0]
    elif k == 2:
        out = x @ kernel[1] + shift_right(x, dilation) @ kernel[0]
    else:
        raise ValueError(f"causal_conv1d takes kernel_size 1 or 2, got {k}")
    if bias is not None:
        out = out + bias
    return out


def conv1d_step(
    x_tap: torch.Tensor,
    x_now: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-timestep K=2 dilated conv for AR generation (Fast WaveNet):
    given the queued x[t-d] (`x_tap`, (B, Cin)) and the current x[t]
    (`x_now`, (B, Cin)), return y[t] (B, Cout)."""
    out = x_now @ kernel[1] + x_tap @ kernel[0]
    if bias is not None:
        out = out + bias
    return out


def conv_transpose1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    stride: int,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Length-exact transposed conv (upsampling by `stride`).

    x (B, F, Cin), kernel (K, Cin, Cout) -> (B, F*stride, Cout).

    The reference's `lax.conv_transpose` correlates the stride-dilated
    input with the kernel as stored; torch's transposed conv scatters it,
    which is the same map with the kernel flipped in time.  The full
    overlap-add output has (F-1)*stride + K samples and is cropped to
    F*stride, starting at lead = (K - stride) // 2.
    """
    k = kernel.shape[0]
    if k < stride:
        raise ValueError("kernel must be >= stride for exact upsampling")
    w = kernel.permute(1, 2, 0).flip(-1)  # (Cin, Cout, K)
    out = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride)
    lead = (k - stride) // 2
    out = out[:, :, lead: lead + x.shape[1] * stride].transpose(1, 2)
    if bias is not None:
        out = out + bias
    return out
