"""The student's logistic base distribution (counterpart of the logistic
pieces of `pwn_tpu/ops/mol.py`).

The discretized mixture of logistics belongs to the teacher and is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_U_MIN = 1e-5


def logistic_log_density(
    x: torch.Tensor, mean: torch.Tensor, log_scale: torch.Tensor
) -> torch.Tensor:
    """log pdf of a single logistic(mean, scale)."""
    z = (x - mean) * torch.exp(-log_scale)
    return z - log_scale - 2.0 * F.softplus(z)


def sample_logistic(generator: torch.Generator, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """z ~ Logistic(0, 1) on the generator's device: u ~ U[1e-5, 1-1e-5],
    z = log u - log1p(-u)."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    u = _U_MIN + u * (1.0 - 2.0 * _U_MIN)
    return torch.log(u) - torch.log1p(-u)
