"""Waveform generation (counterpart of the student and teacher paths of
`pwn_tpu/generate.py`): the student's mel -> waveform in one parallel
pass, for one utterance (`generate_student`) or many of any lengths
(`vocode_many`, the CLI's `generate --source-dir` path), and the
teacher's autoregressive synthesis (`generate_teacher`).

Noise comes from torch generators, so it differs from `jax.random`'s;
the student entry points also take the noise `z` explicitly, and the
sampling functions under `generate_teacher` take `noise=`, which is how
the tests hold the port against the reference.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models import sampling
from pwn_tpu_torch.models.student import StudentIAF, sample_base_noise
from pwn_tpu_torch.models.teacher import TeacherWaveNet
from pwn_tpu_torch.parallel.sp import sp_mega_geometry
from pwn_tpu_torch.utils import dsp
from pwn_tpu_torch.utils.platform import require_cuda


def mel_from_wav(cfg: Config, wav: np.ndarray, device=None) -> torch.Tensor:
    """Host wav (T,) float32 -> conditioning mel (1, T//hop, n_mels) float32
    on `device` (default: the CUDA card; the CPU only when passed):
    preemphasis, clip to [-1, 1], normalized log-mel."""
    if device is None:
        device = require_cuda()
    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)[None]
    x = torch.clamp(dsp.preemphasis(x, cfg.dsp.preemphasis), -1.0, 1.0)
    mel = dsp.mel_spectrogram(x, cfg.dsp)
    return mel[:, : wav.shape[-1] // cfg.dsp.hop_length]


def coerce_mel(cfg: Config, mel) -> np.ndarray:
    """Externally supplied mel (F, n_mels) or (1, F, n_mels) -> validated
    host (1, F, n_mels) float32 array.  The convention is
    `mel_spectrogram`'s: cfg.dsp.n_mels Slaney bands, dB normalized to
    [0, 1], from a preemphasized source."""
    if isinstance(mel, torch.Tensor):
        mel = mel.detach().cpu().numpy()
    arr = np.asarray(mel, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    if (arr.ndim != 3 or arr.shape[0] != 1
            or arr.shape[-1] != cfg.dsp.n_mels):
        raise ValueError(
            f"mel must be (frames, {cfg.dsp.n_mels}) or "
            f"(1, frames, {cfg.dsp.n_mels}); got {arr.shape}"
        )
    if not np.isfinite(arr).all():
        raise ValueError("mel contains non-finite values")
    return arr


def _host_deemphasis(wav: np.ndarray, coef: float) -> np.ndarray:
    """Deemphasis IIR x[t] = y[t] + coef*x[t-1] on the host: a sequential
    filter has no parallelism for the card to use."""
    if coef == 0.0:
        return np.asarray(wav, np.float32)
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coef], np.asarray(wav),
                   axis=-1).astype(np.float32)


def item_generator(seed: int, index: int, device) -> torch.Generator:
    """The noise stream of item `index`: seeded by (seed, index) alone, so
    an item's audio does not depend on which batch it lands in."""
    state = np.random.SeedSequence([seed, index]).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def generate_student(cfg: Config, model: StudentIAF, mel,
                     generator: torch.Generator | None = None,
                     temperature: float = 1.0,
                     z: torch.Tensor | None = None) -> np.ndarray:
    """Single-pass synthesis of mel (1, F, n_mels); returns the first row's
    deemphasized (F*hop,) float32 waveform.  Noise is drawn from
    `generator` unless `z` (B, F*hop) is given."""
    device = _model_device(model)
    mel = torch.as_tensor(mel, dtype=torch.float32, device=device)
    B, Fr = mel.shape[0], mel.shape[1]
    if z is None:
        if generator is None:
            raise ValueError("pass generator= or z=")
        z = sample_base_noise(cfg, generator, (B, Fr * cfg.dsp.hop_length))
    wav = model.generate_from_z(z.to(device) * temperature, mel)
    return _host_deemphasis(wav.cpu().numpy(), cfg.dsp.preemphasis)[0]


@torch.inference_mode()
def vocode_many(cfg: Config, model: StudentIAF, mels: Sequence,
                seed: int = 0, temperature: float = 1.0,
                batch_size: int = 8, bucket_frames: int = 64,
                z: Sequence | None = None) -> list:
    """Vocode many variable-length utterances at batched throughput.

    Items are bucketed by length (rounded up to `bucket_frames`) and run
    through the flows in `batch_size` groups; a ragged group is filled
    with repeats of its last item, whose outputs are dropped.  Each
    item's result is exact, independent of batch composition and padding:
    the flows are causal over (z, cond), so padded tails cannot reach a
    real sample, and the upsampler (the only non-causal module) is made
    exact at the true right boundary by a tail splice.  A zero mel frame
    adds nothing to a transposed conv, so the bucket-padded conditioning
    differs from the true-length one only within the upsampler's halo H
    of the boundary; re-upsampling the item's last W = 2H+4 frames and
    splicing in its last S = (H+2)*hop samples overwrites every such
    position with an exact value.  Items shorter than W frames are
    upsampled alone at their true length.

    Item i's noise is `sample_base_noise` of the bucket length from
    `item_generator(seed, i)`, or `z[i]` (at least T_i samples) if given,
    times `temperature`.  Item i's waveform then equals
    `generate_from_z(z_i[:T_i], mel_i)`, deemphasized on the host.

    mels: (F_i, n_mels) or (1, F_i, n_mels) arrays.  Returns a list of
    (T_i,) float32 numpy waveforms, in order.
    """
    device = _model_device(model)
    hop = cfg.dsp.hop_length
    _, H = sp_mega_geometry(cfg)
    W = 2 * H + 4
    S = (H + 2) * hop
    items = [coerce_mel(cfg, m)[0] for m in mels]
    if z is not None and len(z) != len(items):
        raise ValueError(f"got {len(z)} noise arrays for {len(items)} mels")
    buckets: dict = {}
    for i, m in enumerate(items):
        fb = -(-m.shape[0] // bucket_frames) * bucket_frames
        buckets.setdefault(fb, []).append(i)

    def noise(i: int, Tb: int) -> torch.Tensor:
        if z is None:
            return sample_base_noise(cfg, item_generator(seed, i, device),
                                     (Tb,))
        zi = torch.as_tensor(np.asarray(z[i], np.float32)[:Tb], device=device)
        if zi.shape[0] < items[i].shape[0] * hop:
            raise ValueError(f"z[{i}] is shorter than item {i}")
        return F.pad(zi, (0, Tb - zi.shape[0]))

    def up(mel: np.ndarray) -> torch.Tensor:
        return model.upsample_cond(torch.as_tensor(mel, device=device))

    out: list = [None] * len(items)
    for fb in sorted(buckets):
        idxs = buckets[fb]
        Tb = fb * hop
        for at in range(0, len(idxs), batch_size):
            group = idxs[at: at + batch_size]
            rows = group + [group[-1]] * (batch_size - len(group))
            if all(items[i].shape[0] >= W for i in group):
                cond = up(np.stack([
                    np.pad(items[i], ((0, fb - items[i].shape[0]), (0, 0)))
                    for i in rows]))
                tails = up(np.stack([items[i][-W:] for i in rows]))
                for row, i in enumerate(rows):
                    T_i = items[i].shape[0] * hop
                    cond[row, T_i - S: T_i] = tails[row, -S:]
            else:
                cond = torch.cat([
                    F.pad(up(items[i][None]),
                          (0, 0, 0, Tb - items[i].shape[0] * hop))
                    for i in rows])
            zb = torch.stack([noise(i, Tb) for i in rows]) * temperature
            wav = model.flows_from_z(zb, cond).cpu().numpy()
            wav = _host_deemphasis(wav, cfg.dsp.preemphasis)
            for row, i in enumerate(group):
                out[i] = wav[row, : items[i].shape[0] * hop]
    return out


AR_BACKENDS = ("auto", "kernel", "pallas", "scan")


@torch.inference_mode()
def generate_teacher(cfg: Config, teacher: TeacherWaveNet, mel,
                     generator: torch.Generator, temperature: float = 1.0,
                     ar_backend: str = "auto",
                     ar_weights_dtype: str | None = None) -> np.ndarray:
    """AR teacher synthesis of mel (B, F, n_mels); returns the first row's
    deemphasized (F*hop,) float32 waveform, as the reference does.

    ar_backend: "auto" and "kernel" (or the reference's name "pallas")
    run the whole-loop sampler, `sampling.fast_sample_kernel`: the CUDA
    kernel on a model on the card, its plain version on a CPU model;
    "scan" runs the eager conv-queue loop `sampling.fast_sample`, only when
    asked for.  ar_weights_dtype ("float32" or "bfloat16") overrides the
    whole-loop sampler's weight storage (compute is fp32 either way);
    None keeps the compute dtype.  Noise is drawn from `generator`, which
    lives on the model's device.
    """
    if ar_backend not in AR_BACKENDS:
        raise ValueError(f"ar_backend {ar_backend!r}; one of {AR_BACKENDS}")
    mel = torch.as_tensor(mel, dtype=torch.float32,
                          device=_model_device(teacher))
    if ar_backend == "scan":
        wav = sampling.fast_sample(teacher, generator, mel,
                                   temperature=temperature)
    else:
        wav = sampling.fast_sample_kernel(teacher, generator, mel,
                                          temperature=temperature,
                                          weights_dtype=ar_weights_dtype)
    return _host_deemphasis(wav.cpu().numpy(), cfg.dsp.preemphasis)[0]
