"""Normalization variants (counterpart of `pwn_tpu/ops/norm.py`).

* `instance_norm` — per-(batch, channel) normalization over time.
* `weight_norm` — a conv kernel reparameterized as g * v / ||v|| (per
  output channel); `WeightNormConv1d` is a causal conv module using it
  (parameters v (K, Cin, Cout), g (Cout,), bias (Cout,)), and
  `models/modules.py::UpsampleNet(weight_norm=True)` uses it for the
  transposed convs.

Both run as plain PyTorch ops: they sit outside the flow stack, where no
kernel of the port reaches.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pwn_tpu_torch.ops.conv import causal_conv1d


def instance_norm(x: torch.Tensor, gamma: torch.Tensor | None = None,
                  beta: torch.Tensor | None = None, eps: float = 1e-5,
                  axis: int = 1) -> torch.Tensor:
    """Normalize (B, T, C) over the time axis per batch row and channel,
    with the biased variance (`jnp.var`'s)."""
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.var(x, dim=axis, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


def kernel_norm(v: torch.Tensor) -> torch.Tensor:
    """||v|| over (K, Cin) per output channel, shaped (1, 1, Cout)."""
    return torch.sqrt(torch.sum(torch.square(v), dim=(0, 1), keepdim=True))


def weight_norm(v: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Kernel (K, Cin, Cout) = v * g / max(||v||_{K,Cin}, eps) per output
    channel."""
    return v * (g / torch.clamp(kernel_norm(v), min=eps))


def init_weight_norm_(v: torch.Tensor, g: torch.Tensor) -> None:
    """g <- ||v|| of the v just drawn, so that the initial kernel
    `weight_norm(v, g)` equals v exactly (x / x is exactly 1)."""
    with torch.no_grad():
        g.copy_(kernel_norm(v).reshape(g.shape))


class WeightNormConv1d(nn.Module):
    """Causal dilated conv (K = 1 or 2) with a weight-normalized kernel."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dilation = dilation
        self.dtype = dtype
        self.v = nn.Parameter(torch.zeros(kernel_size, in_channels, features,
                                          device=device))
        self.g = nn.Parameter(torch.zeros(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's fan-in truncated normal for v, g = ||v||, zero bias."""
        from pwn_tpu_torch.models.modules import fan_in_init_

        fan_in_init_(self.v, self.v.shape[0] * self.v.shape[1], generator)
        init_weight_norm_(self.v, self.g)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return causal_conv1d(x.to(dt), weight_norm(self.v, self.g).to(dt),
                             self.dilation, self.bias.to(dt))


class InstanceNorm(nn.Module):
    """Learnable instance norm over time for (B, T, C): gamma ones, beta
    zeros."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.gamma, self.beta, self.eps)
