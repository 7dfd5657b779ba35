"""Mixture-of-logistics ops (counterpart of `pwn_tpu/ops/mol.py`): the
teacher's discretized MoL likelihood, its sampler (teacher AR sampling),
the continuous MoL density (distillation) and the student's logistic
base.

The likelihood runs in fp32 whatever the stack's compute dtype, with the
reference's branches and clamps.  Parameter layout: `params[..., 3K]` is
[logit_probs | means | log_scales].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_U_MIN = 1e-5
NUM_CLASSES = 65536  # 16-bit amplitude discretization


def split_params(params: torch.Tensor):
    """(logit_probs, means, log_scales), each (..., K) in fp32."""
    k = params.shape[-1] // 3
    p = params.float()
    return p[..., :k], p[..., k:2 * k], p[..., 2 * k:]


def discretized_mol_log_prob(x: torch.Tensor, params: torch.Tensor,
                             num_classes: int = NUM_CLASSES,
                             log_scale_min: float = -9.0) -> torch.Tensor:
    """Log-probability (...,) of x in [-1, 1] under the discretized MoL
    params (..., 3K): the bin's CDF mass, the logistic density at the bin
    centre where that mass underflows, and the open-ended edge bins."""
    logit_probs, means, log_scales = split_params(params)
    log_scales = torch.clamp(log_scales, min=log_scale_min)
    x = x.float()[..., None]

    half_bin = 1.0 / (num_classes - 1)
    centered = x - means
    inv_s = torch.exp(-log_scales)
    plus_in = inv_s * (centered + half_bin)
    min_in = inv_s * (centered - half_bin)

    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_s * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    inner = torch.where(
        cdf_delta > 1e-5,
        torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid + math.log(half_bin * 2.0),
    )
    log_probs = torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min, inner))
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    return torch.logsumexp(log_probs, dim=-1)


def discretized_mol_loss(x: torch.Tensor, params: torch.Tensor,
                         num_classes: int = NUM_CLASSES,
                         log_scale_min: float = -9.0) -> torch.Tensor:
    """Mean negative log-likelihood (nats per sample)."""
    return -discretized_mol_log_prob(x, params, num_classes,
                                     log_scale_min).mean()


def mol_log_density(x: torch.Tensor, params: torch.Tensor,
                    log_scale_min: float = -9.0) -> torch.Tensor:
    """Continuous mixture-of-logistics log-density log p(x) (...,) under
    params (..., 3K), fp32: the distillation cross-entropy's teacher term,
    evaluated at the student's own sample."""
    logit_probs, means, log_scales = split_params(params)
    log_scales = torch.clamp(log_scales, min=log_scale_min)
    mid_in = (x.float()[..., None] - means) * torch.exp(-log_scales)
    log_pdf = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    return torch.logsumexp(log_pdf + torch.log_softmax(logit_probs, dim=-1),
                           dim=-1)


def logistic_log_density(
    x: torch.Tensor, mean: torch.Tensor, log_scale: torch.Tensor
) -> torch.Tensor:
    """log pdf of a single logistic(mean, scale)."""
    z = (x - mean) * torch.exp(-log_scale)
    return z - log_scale - 2.0 * F.softplus(z)


def clipped_uniform(generator: torch.Generator, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u ~ U[1e-5, 1-1e-5] on the generator's device, the reference's
    `jax.random.uniform(minval=1e-5, maxval=1-1e-5)`."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    return _U_MIN + u * (1.0 - 2.0 * _U_MIN)


def sample_from_mol(generator: torch.Generator, params: torch.Tensor,
                    log_scale_min: float = -9.0,
                    temperature: float = 1.0) -> torch.Tensor:
    """One sample per leading position of params (..., 3K), in [-1, 1]:
    Gumbel-max choice of the component, then the logistic's inverse CDF,
    with uniforms drawn from `generator` (on the params' device)."""
    logit_probs, means, log_scales = split_params(params)
    log_scales = torch.clamp(log_scales, min=log_scale_min)
    u_mix = clipped_uniform(generator, logit_probs.shape).to(params.device)
    comp = torch.argmax(logit_probs - torch.log(-torch.log(u_mix)), dim=-1,
                        keepdim=True)
    mean = torch.gather(means, -1, comp)[..., 0]
    log_scale = torch.gather(log_scales, -1, comp)[..., 0]
    u = clipped_uniform(generator, mean.shape).to(params.device)
    x = mean + torch.exp(log_scale) * temperature * (
        torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)


def mol_sample_from_uniforms(params_t: torch.Tensor, u: torch.Tensor,
                             log_scale_min: float,
                             temperature: float) -> torch.Tensor:
    """Deterministic MoL sample from pre-drawn uniforms u (..., K+1): K for
    the Gumbel-max choice, the last for the logistic's inverse CDF.  A tie
    splits the one-hot evenly, as in the AR kernel; the result is clipped
    to [-1, 1]."""
    K = params_t.shape[-1] // 3
    logits, means, log_s = split_params(params_t)
    log_s = torch.clamp(log_s, min=log_scale_min)
    u = u.float()
    scores = logits - torch.log(-torch.log(u[..., :K]))
    onehot = (scores >= scores.amax(-1, keepdim=True)).float()
    onehot = onehot / onehot.sum(-1, keepdim=True)
    mean = (means * onehot).sum(-1)
    ls = (log_s * onehot).sum(-1)
    ul = u[..., K]
    x = mean + torch.exp(ls) * temperature * (torch.log(ul) - torch.log1p(-ul))
    return torch.clamp(x, -1.0, 1.0)


def sample_logistic(generator: torch.Generator, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """z ~ Logistic(0, 1) on the generator's device: u ~ U[1e-5, 1-1e-5],
    z = log u - log1p(-u)."""
    u = clipped_uniform(generator, shape, dtype)
    return torch.log(u) - torch.log1p(-u)
