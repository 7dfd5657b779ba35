"""Single-Gaussian output ops, the ClariNet-style alternative to the
mixture-of-logistics head (counterpart of `pwn_tpu/ops/gaussian.py`).

`teacher.output="gaussian"` gives the teacher a two-unit head
(mean, log_scale); its likelihood is the continuous Gaussian NLL with a
clamped log-scale floor, and the reverse KL to a Gaussian student has a
closed form (`kl_gaussian`).  Parameter layout: `params[..., 2]` =
(mean, log_scale), fp32 math.
"""

from __future__ import annotations

import math

import torch


def split_params(params: torch.Tensor):
    """(..., 2) head output -> fp32 (mean, log_scale)."""
    p = params.float()
    return p[..., 0], p[..., 1]


def gaussian_log_density(x: torch.Tensor, mean: torch.Tensor,
                         log_scale: torch.Tensor) -> torch.Tensor:
    """log N(x; mean, exp(log_scale)^2), elementwise fp32."""
    z = (x.float() - mean) * torch.exp(-log_scale)
    return -0.5 * (z * z) - log_scale - 0.5 * math.log(2.0 * math.pi)


def gaussian_nll(x: torch.Tensor, params: torch.Tensor,
                 log_scale_min: float = -9.0) -> torch.Tensor:
    """Mean negative log-likelihood (nats per sample) of the (mu, log_s)
    head, with the log-scale clamped at `log_scale_min`."""
    mean, log_scale = split_params(params)
    log_scale = torch.clamp(log_scale, min=log_scale_min)
    return -gaussian_log_density(x, mean, log_scale).mean()


def sample_from_normals(params_t: torch.Tensor, eps: torch.Tensor,
                        log_scale_min: float,
                        temperature: float) -> torch.Tensor:
    """Gaussian-head sample from pre-drawn standard normals `eps` (the
    leading shape of params_t), clipped to [-1, 1]: the AR kernel's
    gaussian head."""
    mean, log_scale = split_params(params_t)
    log_scale = torch.clamp(log_scale, min=log_scale_min)
    x = mean + torch.exp(log_scale) * temperature * eps.float()
    return torch.clamp(x, -1.0, 1.0)


def sample_normal(generator: torch.Generator, shape,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """z ~ N(0, 1) on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype)


def sample_from_gaussian(generator: torch.Generator, params: torch.Tensor,
                         log_scale_min: float = -9.0,
                         temperature: float = 1.0) -> torch.Tensor:
    """One sample per leading position of params (..., 2), in [-1, 1],
    with the normal drawn from `generator` (on the params' device)."""
    eps = sample_normal(generator, params.shape[:-1]).to(params.device)
    return sample_from_normals(params, eps, log_scale_min, temperature)


def kl_gaussian(mu_q: torch.Tensor, log_s_q: torch.Tensor,
                mu_p: torch.Tensor, log_s_p: torch.Tensor) -> torch.Tensor:
    """Elementwise KL( N(mu_q, s_q^2) || N(mu_p, s_p^2) ), fp32:

        KL = log(s_p/s_q) + (s_q^2 + (mu_q - mu_p)^2) / (2 s_p^2) - 1/2
    """
    d = mu_q.float() - mu_p.float()
    log_r = log_s_p.float() - log_s_q.float()
    return log_r + 0.5 * (
        torch.exp(-2.0 * log_r) * (1.0 + d * d * torch.exp(-2.0 * log_s_q.float()))
        - 1.0)
