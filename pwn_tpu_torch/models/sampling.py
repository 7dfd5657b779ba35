"""Teacher autoregressive sampling (counterpart of
`pwn_tpu/models/sampling.py`): the O(T^2) ground truth, the Fast-WaveNet
conv-queue loop, and the whole-loop kernel path.

Algorithm: Fast WaveNet (arXiv:1611.09482), O(1) work per emitted
sample.  Each layer keeps a ring queue of its last d_l inputs, indexed
`t % d_l`; the conditioning is upsampled once, outside the loop.

* `fast_sample_kernel` (the "kernel" backend, what `generate_teacher`
  runs): the stack packed by `stack_teacher_weights`, then `ar_sample`,
  one launch of `csrc/ar_sampler.cu` for the whole waveform on a CUDA
  model and its plain version on a CPU one.
* `fast_sample` (the "scan" backend): the same loop in eager PyTorch,
  per-layer GEMMs on the fp32 parameters.
* `naive_sample`: re-runs the whole teacher-forcing pass per emitted
  sample; only for short T.

Noise: the kernel path consumes a pre-drawn stream, (T, B, K+1) uniforms
in [1e-5, 1 - 1e-5] for the MoL head or (T, B, 1) standard normals for the
Gaussian one (`draw_noise`), from a torch generator on its own device.
Every backend takes `noise=` as well, which is how the tests feed the
reference and the port one stream.
"""

from __future__ import annotations

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models.modules import DTYPES, match_length
from pwn_tpu_torch.models.teacher import TeacherWaveNet
from pwn_tpu_torch.ops import gaussian, mol
from pwn_tpu_torch.ops.ar_sampler import ar_sample, stack_teacher_weights
from pwn_tpu_torch.ops.conv import conv1d_step
from pwn_tpu_torch.ops.mol import mol_sample_from_uniforms


def _device(model: TeacherWaveNet) -> torch.device:
    return next(model.parameters()).device


def teacher_cond(model: TeacherWaveNet, mel: torch.Tensor,
                 n_samples: int) -> torch.Tensor:
    """(B, F, n_mels) mel -> (B, n_samples, n_mels) conditioning in the
    compute dtype."""
    return match_length(model.condition(mel), n_samples)


def draw_uniforms(generator: torch.Generator, T: int, B: int,
                  K: int) -> torch.Tensor:
    """The (T, B, K+1) uniform stream of the MoL head."""
    return mol.clipped_uniform(generator, (T, B, K + 1))


def draw_normals(generator: torch.Generator, T: int, B: int) -> torch.Tensor:
    """The (T, B, 1) N(0, 1) stream of the Gaussian head."""
    return gaussian.sample_normal(generator, (T, B, 1))


def draw_noise(cfg: Config, generator: torch.Generator, T: int,
               B: int) -> torch.Tensor:
    """Pre-drawn per-step noise stream for the configured head."""
    if cfg.teacher.output == "gaussian":
        return draw_normals(generator, T, B)
    return draw_uniforms(generator, T, B, cfg.teacher.n_mixtures)


def _mel_and_cond(model: TeacherWaveNet, mel):
    cfg = model.config
    mel = torch.as_tensor(mel, dtype=torch.float32, device=_device(model))
    T = mel.shape[1] * cfg.dsp.hop_length
    return mel, T, teacher_cond(model, mel, T)


def _draw(cfg: Config, params_t, t: int, noise, generator, temperature):
    tc = cfg.teacher
    if noise is not None and tc.output == "gaussian":
        return gaussian.sample_from_normals(params_t, noise[t, :, 0],
                                            tc.log_scale_min, temperature)
    if noise is not None:
        return mol_sample_from_uniforms(params_t, noise[t], tc.log_scale_min,
                                        temperature)
    sample = (gaussian.sample_from_gaussian if tc.output == "gaussian"
              else mol.sample_from_mol)
    return sample(generator, params_t, log_scale_min=tc.log_scale_min,
                  temperature=temperature)


@torch.no_grad()
def fast_sample(model: TeacherWaveNet, generator: torch.Generator | None,
                mel, temperature: float = 1.0,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """AR-sample a waveform (B, F*hop) with cached conv queues, one eager
    step at a time on the fp32 parameters.  Draws from `generator` step by
    step unless `noise` (the `draw_noise` stream) is given."""
    cfg = model.config
    mel, T, cond = _mel_and_cond(model, mel)
    B = mel.shape[0]
    st = model.stack
    C = cfg.teacher.residual_channels
    dev = cond.device
    if noise is not None:
        noise = noise.to(dev)
    queues = [torch.zeros((B, d, C), device=dev) for d in st.dilations]
    x_prev = torch.zeros((B,), device=dev)
    wav = torch.empty((T, B), device=dev)
    for t in range(T):
        cond_t = cond[:, t].float()
        h = x_prev[:, None] @ st.front.kernel[0] + st.front.bias
        skip = torch.zeros((B, cfg.teacher.skip_channels), device=dev)
        for lp, d, q in zip(st.layers, st.dilations, queues):
            tap = q[:, t % d].clone()
            q[:, t % d] = h
            g = (conv1d_step(tap, h, lp.w_dilated, lp.b_dilated)
                 + cond_t @ lp.w_cond + lp.b_cond)
            a, b = g.chunk(2, dim=-1)
            z = torch.tanh(a) * torch.sigmoid(b)
            h = h + z @ lp.w_res + lp.b_res
            skip = skip + z @ lp.w_skip + lp.b_skip
        hh = torch.relu(skip)
        hh = torch.relu(hh @ st.head1.kernel[0] + st.head1.bias)
        params_t = hh @ st.head2.kernel[0] + st.head2.bias
        x_prev = _draw(cfg, params_t, t, noise, generator, temperature)
        wav[t] = x_prev
    return wav.T.contiguous()


@torch.no_grad()
def fast_sample_kernel(model: TeacherWaveNet,
                       generator: torch.Generator | None, mel,
                       temperature: float = 1.0,
                       weights_dtype: str | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """AR-sample (B, F*hop) with the whole-loop sampler (`ar_sample`): the
    kernel on a CUDA model, its plain version on a CPU one.  The stack's
    weights are stored in `weights_dtype` (default the compute dtype;
    compute is fp32 either way).  Noise is `draw_noise` from `generator`
    unless `noise` is given."""
    cfg = model.config
    tc = cfg.teacher
    mel, T, cond = _mel_and_cond(model, mel)
    if noise is None:
        noise = draw_noise(cfg, generator, T, mel.shape[0])
    weights = stack_teacher_weights(
        model.stack, DTYPES[weights_dtype or tc.compute_dtype])
    return ar_sample(
        cond.contiguous(), noise.to(cond.device, torch.float32).contiguous(),
        weights, dilations=tc.dilations, n_mixtures=tc.n_mixtures,
        head=tc.output, log_scale_min=tc.log_scale_min,
        temperature=temperature)


@torch.no_grad()
def naive_sample(model: TeacherWaveNet, mel, noise: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    """O(T^2) ground truth: re-runs the whole teacher-forcing pass for every
    emitted sample, drawing from the pre-drawn `noise` stream.  Only for
    short T and CPU models."""
    cfg = model.config
    mel, T, cond = _mel_and_cond(model, mel)
    wav = torch.zeros((mel.shape[0], T), device=cond.device)
    for t in range(T):
        params = model.params_from_cond(wav, cond)
        wav[:, t] = _draw(cfg, params[:, t], t, noise, None, temperature)
    return wav
