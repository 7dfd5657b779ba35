"""Plain PyTorch reference of the WaveNet family the benchmark's cells run:
the mel upsampler, the gated dilated stack, the student IAF's flows, the
teacher's mel front end and discretized mixture-of-logistics loss, the
clipped Adam step and the MoL draw from pre-drawn uniforms.

It is written from the published equations (WaveNet, arXiv:1609.03499;
Parallel WaveNet, arXiv:1711.10433) in float32, with TF32 off, and imports
nothing of the program under test: parameters are a flat dict of float32
tensors named as `params.py` names them, and every input comes from the
benchmark.  `prec` selects the arithmetic: "fp32" (the reference) or "fp8"
(the control of `correct`: every matmul and convolution operand rounded
to float8 e4m3, the precision next below the configurations' bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")
_FP8_MAX = 448.0


def no_tf32() -> None:
    """Full float32 matmuls and convolutions (cuDNN's default is TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q(t: torch.Tensor, prec: str) -> torch.Tensor:
    """A matmul operand in `prec`, returned in float32 (its gradient passes
    the rounding unchanged)."""
    if prec == "fp32":
        return t
    if prec != "fp8":
        raise ValueError(f"precision {prec!r}; one of {PRECISIONS}")
    r = t.detach().clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).float()
    return t + (r - t.detach()) if t.requires_grad else r


def shift_right(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, t - d] along dim 1, zeros before the start."""
    if d >= x.shape[1]:
        return torch.zeros_like(x)
    return F.pad(x, (0, 0, d, 0))[:, : x.shape[1]]


def upsample(mel: torch.Tensor, p: dict, pre: str, strides, prec: str):
    """(B, F, M) mel -> (B, F * prod(strides), M): per stage a transposed
    convolution of stride s with kernel (K, Cin, Cout) as stored
    (y[t*s + k - lead] += x[t] @ W[K - 1 - k], cropped to F*s samples from
    lead = (K - s) // 2), its bias, leaky ReLU 0.4."""
    x = mel.float()
    for i, s in enumerate(strides):
        k = p[f"{pre}kernel_{i}"]
        K = k.shape[0]
        w = q(k, prec).permute(1, 2, 0).flip(-1)
        y = F.conv_transpose1d(q(x, prec).transpose(1, 2), w, stride=s)
        lead = (K - s) // 2
        y = y[:, :, lead: lead + x.shape[1] * s].transpose(1, 2)
        x = F.leaky_relu(y + p[f"{pre}bias_{i}"], 0.4)
    return x


def match_length(cond: torch.Tensor, T: int) -> torch.Tensor:
    """Crop, or repeat the last sample, to T samples."""
    if cond.shape[1] >= T:
        return cond[:, :T]
    return torch.cat([cond, cond[:, -1:].expand(-1, T - cond.shape[1], -1)],
                     dim=1)


def stack(x: torch.Tensor, cond: torch.Tensor, p: dict, pre: str,
          dilations, prec: str) -> torch.Tensor:
    """The WaveNet stack on x (B, T, 1) under cond (B, T, M): front 1x1;
    per layer g = W1 x_t + W0 x_{t-d} + b + Wc c_t + bc,
    z = tanh(g_a) * sigmoid(g_b), x += Wr z + br, skip += Ws z + bs;
    then relu, 1x1, relu, 1x1.  Returns (B, T, out) float32."""
    h = q(x, prec) @ q(p[pre + "front.kernel"][0], prec) + p[pre + "front.bias"]
    c = q(cond, prec)
    skip = 0.0
    for l, d in enumerate(dilations):
        lp = f"{pre}layer_{l}."
        wd = q(p[lp + "w_dilated"], prec)
        hq = q(h, prec)
        g = (hq @ wd[1] + shift_right(hq, d) @ wd[0] + p[lp + "b_dilated"]
             + c @ q(p[lp + "w_cond"], prec) + p[lp + "b_cond"])
        a, b = g.chunk(2, dim=-1)
        z = q(torch.tanh(a) * torch.sigmoid(b), prec)
        h = h + z @ q(p[lp + "w_res"], prec) + p[lp + "b_res"]
        skip = skip + z @ q(p[lp + "w_skip"], prec) + p[lp + "b_skip"]
    hh = q(torch.relu(skip), prec)
    hh = q(torch.relu(hh @ q(p[pre + "head1.kernel"][0], prec)
                      + p[pre + "head1.bias"]), prec)
    return hh @ q(p[pre + "head2.kernel"][0], prec) + p[pre + "head2.bias"]


# --------------------------------------------------------------------------
# student IAF
# --------------------------------------------------------------------------

def student_flows(z: torch.Tensor, cond: torch.Tensor, p: dict, sizes: dict,
                  prec: str) -> torch.Tensor:
    """z (B, T) base noise -> waveform (B, T): per flow
    (mu, log s) = stack(z shifted right by one), log s clipped to
    +-log_scale_clamp, z = z * exp(log s) + mu; then clipped to [-1, 1]."""
    z = z.float()
    dil = [2 ** i for i in range(sizes["layers_per_flow"])]
    clamp = sizes["log_scale_clamp"]
    for i in range(sizes["n_flows"]):
        out = stack(shift_right(z[..., None], 1), cond, p, f"flow_{i}.", dil,
                    prec)
        log_s = out[..., 1].clamp(-clamp, clamp)
        z = z * torch.exp(log_s) + out[..., 0]
    return z.clamp(-1.0, 1.0)


def student_wave(mel: torch.Tensor, z: torch.Tensor, p: dict, sizes: dict,
                 prec: str) -> torch.Tensor:
    """One utterance's synthesis before deemphasis: mel (B, F, M), z
    (B, F * hop) -> (B, F * hop)."""
    cond = match_length(upsample(mel, p, "upsample.", sizes["upsample_strides"],
                                 prec), z.shape[1])
    return student_flows(z, cond, p, sizes, prec)


def deemphasis(y: np.ndarray, coef: float) -> np.ndarray:
    """x[t] = y[t] + coef * x[t-1] along the last axis, in float64."""
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coef], np.asarray(y, np.float64), axis=-1)


# --------------------------------------------------------------------------
# teacher: mel front end, MoL loss, clipped Adam, MoL draw
# --------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-scale triangles with Slaney area normalization,
    (n_mels, n_fft // 2 + 1)."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                n_mels + 2))
    lower = (freqs[None] - hz[:-2, None]) / (hz[1:-1] - hz[:-2])[:, None]
    upper = (hz[2:, None] - freqs[None]) / (hz[2:] - hz[1:-1])[:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return w.astype(np.float32)


def log_mel(x: torch.Tensor, dsp: dict) -> torch.Tensor:
    """(B, T) -> (B, T // hop, n_mels): centred STFT (reflect pad), periodic
    Hann window, |rfft|, Slaney mel, 20 log10 (floor 1e-5), normalized
    (db - ref - min) / -min clipped to [0, 1]."""
    n_fft, hop, win = dsp["n_fft"], dsp["hop_length"], dsp["win_length"]
    xp = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)
    w = torch.zeros(n_fft, dtype=torch.float64)
    n = torch.arange(win, dtype=torch.float64)
    w[(n_fft - win) // 2: (n_fft - win) // 2 + win] = 0.5 * (
        1 - torch.cos(2 * math.pi * n / win))
    mag = torch.fft.rfft(frames * w.float().to(x.device), n=n_fft).abs()
    fb = torch.from_numpy(mel_filterbank(
        dsp["sample_rate"], n_fft, dsp["n_mels"], dsp["fmin"],
        dsp["fmax"] or dsp["sample_rate"] / 2)).to(x.device)
    db = 20.0 * torch.log10((mag @ fb.T).clamp(min=1e-5))
    mel = ((db - dsp["ref_db"] - dsp["min_db"]) / -dsp["min_db"]).clamp(0, 1)
    return mel[:, : x.shape[-1] // hop]


def mol_log_prob(x: torch.Tensor, params: torch.Tensor,
                 log_scale_min: float, num_classes: int = 65536):
    """Discretized mixture of logistics log-probability of x in [-1, 1]
    (bins of width 2 / (num_classes - 1), open edge bins, the density at
    the centre where a bin's mass underflows 1e-5)."""
    K = params.shape[-1] // 3
    logits, means = params[..., :K], params[..., K:2 * K]
    log_s = params[..., 2 * K:].clamp(min=log_scale_min)
    xc = x[..., None] - means
    inv = torch.exp(-log_s)
    half = 1.0 / (num_classes - 1)
    plus, minus = inv * (xc + half), inv * (xc - half)
    cdf_delta = torch.sigmoid(plus) - torch.sigmoid(minus)
    mid = inv * xc
    log_pdf_mid = mid - log_s - 2.0 * F.softplus(mid)
    inner = torch.where(cdf_delta > 1e-5,
                        torch.log(cdf_delta.clamp(min=1e-12)),
                        log_pdf_mid + math.log(2.0 * half))
    lp = torch.where(x[..., None] < -0.999, plus - F.softplus(plus),
                     torch.where(x[..., None] > 0.999, -F.softplus(minus),
                                 inner))
    return torch.logsumexp(lp + torch.log_softmax(logits, -1), -1)


def teacher_params(wav: torch.Tensor, cond: torch.Tensor, p: dict,
                   dilations, prec: str) -> torch.Tensor:
    """Teacher forcing: the head's parameters of every sample of wav (B, T)
    given the samples before it, under cond (B, T, M)."""
    return stack(shift_right(wav[..., None], 1), cond, p, "stack.", dilations,
                 prec)


def teacher_loss(raw: torch.Tensor, p: dict, sizes: dict, dsp: dict,
                 prec: str) -> torch.Tensor:
    """Mean NLL (nats per sample) of a raw waveform batch (B, T): the model
    sees x = clip(preemphasis(raw), -1, 1) and its mel."""
    coef = dsp["preemphasis"]
    x = (raw - coef * F.pad(raw[:, :-1], (1, 0))).clamp(-1.0, 1.0)
    mel = log_mel(x, dsp)
    cond = match_length(upsample(mel, p, "upsample.", sizes["upsample_strides"],
                                 prec), x.shape[1])
    params = teacher_params(x, cond, p, sizes["dilations"], prec)
    return -mol_log_prob(x, params, sizes["log_scale_min"]).mean()


def teacher_loss_and_grads(raw: torch.Tensor, p: dict, names, sizes: dict,
                           dsp: dict, prec: str, rows: int):
    """(loss, grads by name) of the whole batch, computed over blocks of
    `rows` rows so that the activations fit (the loss is a mean over rows
    of equal length, so the block means weigh by rows / B)."""
    B = raw.shape[0]
    leaves = [p[n] for n in names]
    total = 0.0
    grads = [torch.zeros_like(t) for t in leaves]
    for at in range(0, B, rows):
        with torch.enable_grad():
            ps = {n: t.detach().requires_grad_(n in names)
                  for n, t in p.items()}
            part = teacher_loss(raw[at: at + rows], ps, sizes, dsp, prec)
            w = raw[at: at + rows].shape[0] / B
            g = torch.autograd.grad(part * w, [ps[n] for n in names],
                                    allow_unused=True)
        total += float(part.detach()) * w
        for acc, gi in zip(grads, g):
            if gi is not None:    # the last layer's residual output is unused
                acc += gi
    return total, dict(zip(names, grads))


def clipped_adam(params: dict, grads: dict, state: dict, train: dict):
    """One step of global-norm clipping (scale by clip / norm when
    norm >= clip) and Adam (eps 1e-8, bias correction, learning rate
    lr * rate ** (count / decay_steps) on the count before the step), in
    place.  Returns the clipped gradients."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = 1.0 if norm < train["grad_clip_norm"] else (
        train["grad_clip_norm"] / norm)
    count = state.setdefault("count", 0)
    lr = train["learning_rate"] * train["lr_decay_rate"] ** (
        count / train["lr_decay_steps"])
    b1, b2 = train["adam_b1"], train["adam_b2"]
    state["count"] = count + 1
    clipped = {}
    for n, g in grads.items():
        g = (g.double() * scale).float()
        clipped[n] = g
        mu = state.setdefault(("mu", n), torch.zeros_like(g))
        nu = state.setdefault(("nu", n), torch.zeros_like(g))
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (mu / (1 - b1 ** (count + 1))) / (
            torch.sqrt(nu / (1 - b2 ** (count + 1))) + 1e-8)
        params[n] = params[n] - lr * upd
    return clipped


def mol_draw(params: torch.Tensor, u: torch.Tensor, log_scale_min: float,
             temperature: float) -> torch.Tensor:
    """The sample the MoL head gives for uniforms u (..., K+1): the
    component of largest logit + Gumbel(u[:K]) (ties shared evenly), then
    mean + exp(log s) * temperature * logit(u[K]), clipped to [-1, 1]."""
    K = params.shape[-1] // 3
    logits, means = params[..., :K], params[..., K:2 * K]
    log_s = params[..., 2 * K:].clamp(min=log_scale_min)
    scores = logits - torch.log(-torch.log(u[..., :K]))
    pick = (scores >= scores.amax(-1, keepdim=True)).float()
    pick = pick / pick.sum(-1, keepdim=True)
    mean, ls = (means * pick).sum(-1), (log_s * pick).sum(-1)
    ul = u[..., K]
    return (mean + torch.exp(ls) * temperature
            * (torch.log(ul) - torch.log1p(-ul))).clamp(-1.0, 1.0)
