"""Objective copy-synthesis metrics between a reference and a generated
waveform (counterpart of `pwn_tpu/evaluate.py`):

* mel_l2: mean squared distance between normalized mel spectrograms;
* spectral_convergence and log_spectral_distance on |STFT|;
* voiced_metrics: LSD over the reference's voiced frames, the generated
  noise floor in its silent frames, and the voiced fraction.

Every function takes host arrays (or tensors) and a `device`: the CUDA
card by default, the CPU only when passed.  The spectra run in torch on
that device (`utils/dsp.py`); the results are Python floats.
"""

from __future__ import annotations

from typing import Dict

import torch

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.utils import dsp
from pwn_tpu_torch.utils.platform import require_cuda


def _on(device, *wavs) -> list:
    device = require_cuda() if device is None else torch.device(device)
    return [torch.as_tensor(w, dtype=torch.float32, device=device)
            for w in wavs]


def _mag(cfg: Config, x: torch.Tensor) -> torch.Tensor:
    return dsp.stft_magnitude(x, cfg.dsp.n_fft, cfg.dsp.hop_length,
                              cfg.dsp.win_length)


def mel_l2(cfg: Config, wav_a, wav_b, device=None) -> float:
    a, b = _on(device, wav_a, wav_b)
    ma, mb = dsp.mel_spectrogram(a, cfg.dsp), dsp.mel_spectrogram(b, cfg.dsp)
    n = min(ma.shape[-2], mb.shape[-2])
    return float(torch.mean(torch.square(ma[..., :n, :] - mb[..., :n, :])))


def spectral_convergence(cfg: Config, wav_ref, wav_gen, device=None) -> float:
    a, b = (_mag(cfg, x) for x in _on(device, wav_ref, wav_gen))
    n = min(a.shape[-2], b.shape[-2])
    a, b = a[..., :n, :], b[..., :n, :]
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(a), min=1e-8))


def log_spectral_distance(cfg: Config, wav_ref, wav_gen, device=None) -> float:
    a, b = (dsp.amp_to_db(_mag(cfg, x)) for x in _on(device, wav_ref, wav_gen))
    n = min(a.shape[-2], b.shape[-2])
    return float(torch.sqrt(torch.mean(torch.square(a[..., :n, :]
                                                    - b[..., :n, :]))))


def voiced_metrics(cfg: Config, wav_ref, wav_gen, rms_floor: float = 0.01,
                   device=None) -> Dict[str, float]:
    """The fidelity picture split by silence.  Whole-utterance LSD is
    dominated by the log-spectra of silences, so:

    * lsd_voiced_db: LSD over frames whose reference frame RMS is above
      `rms_floor`;
    * silence_noise_floor_db: the mean generated frame RMS in the
      reference's silent frames, in dBFS (lower is cleaner);
    * voiced_fraction: the share of reference frames counted voiced.
    """
    hop = cfg.dsp.hop_length
    ref, gen = _on(device, wav_ref, wav_gen)
    a_db, b_db = dsp.amp_to_db(_mag(cfg, ref)), dsp.amp_to_db(_mag(cfg, gen))
    # the centred STFT can have a frame more than the hop-aligned samples:
    # clamp to the frames common to both spectra and both waveforms
    n = min(a_db.shape[-2], b_db.shape[-2], ref.shape[-1] // hop,
            gen.shape[-1] // hop)
    a_db, b_db = a_db[..., :n, :], b_db[..., :n, :]

    def frame_rms(x):
        x = x[..., : n * hop].reshape(*x.shape[:-1], n, hop)
        return torch.sqrt(torch.mean(torch.square(x), dim=-1))

    r_rms, g_rms = frame_rms(ref), frame_rms(gen)
    voiced = r_rms > rms_floor
    n_voiced = torch.clamp(voiced.sum(), min=1)
    lsd_frames = torch.sqrt(torch.mean(torch.square(a_db - b_db), dim=-1))
    lsd_voiced = torch.where(voiced, lsd_frames, 0.0).sum() / n_voiced
    sil = ~voiced
    noise = torch.where(sil, g_rms, 0.0).sum() / torch.clamp(sil.sum(), min=1)
    return {
        "lsd_voiced_db": float(lsd_voiced),
        "silence_noise_floor_db": float(
            20.0 * torch.log10(torch.clamp(noise, min=1e-8))),
        "voiced_fraction": float(voiced.float().mean()),
    }


def copy_synthesis_report(cfg: Config, wav_ref, wav_gen,
                          device=None) -> Dict[str, float]:
    return {
        "mel_l2": mel_l2(cfg, wav_ref, wav_gen, device),
        "spectral_convergence": spectral_convergence(cfg, wav_ref, wav_gen,
                                                     device),
        "log_spectral_distance_db": log_spectral_distance(cfg, wav_ref,
                                                          wav_gen, device),
        **voiced_metrics(cfg, wav_ref, wav_gen, device=device),
    }
