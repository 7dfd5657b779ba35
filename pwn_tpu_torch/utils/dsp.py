"""DSP for conditioning and the power loss: preemphasis, the STFT magnitude
and the normalized log-mel spectrogram (counterpart of
`pwn_tpu/utils/dsp.py`).

The conventions are the reference's, frozen by its goldens:
  * preemphasis:    y[t] = x[t] - coef * x[t-1], y[0] = x[0]
  * STFT:           centered (reflect pad n_fft//2), periodic Hann window
                    of `win_length` zero-padded to `n_fft`, rfft magnitude
  * mel filterbank: Slaney mel scale + Slaney area normalization
  * amplitude->dB:  20*log10(max(amp, 1e-5)), then `normalize_db` maps
                    [min_db, 0] -> [0, 1] after subtracting ref_db

The filterbank and the window are numpy constants, copied from the
reference (whose module imports JAX).  The transforms run in torch on
the input tensor's device.  Deemphasis is a host IIR
(`generate._host_deemphasis`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pwn_tpu_torch.config import DSPConfig

_AMP_FLOOR = 1e-5


def hz_to_mel(freq: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    safe = np.maximum(freq, min_log_hz)
    mels = np.where(
        log_region, min_log_mel + np.log(safe / min_log_hz) / logstep, mels
    )
    return mels


def mel_to_hz(mels: np.ndarray | float) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1)
    (librosa.filters.mel(htk=False, norm='slaney'))."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each triangle integrates to ~constant energy.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of win_length, centered and zero-padded to n_fft."""
    if win_length > n_fft:
        raise ValueError("win_length must be <= n_fft")
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    pad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[pad : pad + win_length] = w
    return out


def preemphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - coef*x[t-1] along the last axis (y[0] = x[0])."""
    if coef == 0.0:
        return x
    shifted = torch.nn.functional.pad(x[..., :-1], (1, 0))
    return x - coef * shifted


def normalize_db(db: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """Map dB to [0, 1]: clip((db - ref_db - min_db) / -min_db, 0, 1)."""
    return torch.clamp((db - cfg.ref_db - cfg.min_db) / (-cfg.min_db), 0.0, 1.0)


def frame(x: torch.Tensor, n_fft: int, hop: int,
          center: bool = True) -> torch.Tensor:
    """Overlapping frames (..., n_frames, n_fft) of a signal (..., T),
    reflect-padded by n_fft // 2 on each side when `center`."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if center:
        pad = n_fft // 2
        flat = torch.nn.functional.pad(flat[:, None], (pad, pad),
                                       mode="reflect")[:, 0]
    frames = flat.unfold(-1, n_fft, hop)
    return frames.reshape(*lead, *frames.shape[-2:])


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int, win_length: int,
                   center: bool = True) -> torch.Tensor:
    """|STFT| of (..., T) -> (..., n_frames, n_fft // 2 + 1), float32, on
    x's device: the periodic Hann window of `win_length` centred in n_fft,
    then a real FFT (`torch.fft.rfft`, as the reference leaves its FFT to
    XLA)."""
    frames = frame(x.to(torch.float32), n_fft, hop, center=center)
    win = torch.from_numpy(hann_window(win_length, n_fft)).to(x.device)
    return torch.fft.rfft(frames * win, n=n_fft, dim=-1).abs()


def mel_spectrogram(x: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """Normalized log-mel spectrogram of (..., T) -> (..., frames, n_mels),
    float32, on x's device."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
    mag = stft_magnitude(flat, cfg.n_fft, cfg.hop_length, cfg.win_length)
    fbank = torch.from_numpy(
        mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                       cfg.fmax_hz)
    ).to(x.device)
    mel = mag @ fbank.T
    db = 20.0 * torch.log10(torch.clamp(mel, min=_AMP_FLOOR))
    out = normalize_db(db, cfg)
    return out.reshape(*lead, *out.shape[-2:])
