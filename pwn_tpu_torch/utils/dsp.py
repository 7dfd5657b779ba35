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
reference (whose module imports JAX), and so is `mel_spectrogram_np`, its
host mirror of the mel pipeline.  The transforms run in torch on the input
tensor's device.  Deemphasis is a host IIR (`generate._host_deemphasis`).
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


def amp_to_db(amp: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(amp, min=_AMP_FLOOR))


def db_to_amp(db: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, db * 0.05)


def normalize_db(db: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """Map dB to [0, 1]: clip((db - ref_db - min_db) / -min_db, 0, 1)."""
    return torch.clamp((db - cfg.ref_db - cfg.min_db) / (-cfg.min_db), 0.0, 1.0)


def denormalize_db(norm: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    return torch.clamp(norm, 0.0, 1.0) * (-cfg.min_db) + cfg.min_db + cfg.ref_db


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
    out = normalize_db(amp_to_db(mag @ fbank.T), cfg)
    return out.reshape(*lead, *out.shape[-2:])


def linear_spectrogram(x: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """Normalized linear-magnitude spectrogram (..., frames, n_fft//2+1)."""
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win_length)
    return normalize_db(amp_to_db(mag), cfg)


def wav_to_mel(wav: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """wav -> conditioning mel: preemphasis, then `mel_spectrogram`."""
    return mel_spectrogram(preemphasis(wav, cfg.preemphasis), cfg)


def power_spectrum(x: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """|STFT|^2, un-normalized: the distillation power loss's feature."""
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win_length)
    return torch.square(mag)


def mel_spectrogram_np(x: np.ndarray, cfg: DSPConfig) -> np.ndarray:
    """`mel_spectrogram` in numpy, (..., T) -> (..., F, n_mels), for mel
    extraction on the host (the server's wav requests)."""
    x = np.asarray(x, np.float32)
    pad = [(0, 0)] * (x.ndim - 1) + [(cfg.n_fft // 2, cfg.n_fft // 2)]
    xp = np.pad(x, pad, mode="reflect")
    n_frames = 1 + (xp.shape[-1] - cfg.n_fft) // cfg.hop_length
    idx = (np.arange(n_frames)[:, None] * cfg.hop_length
           + np.arange(cfg.n_fft)[None, :])
    frames = xp[..., idx] * hann_window(cfg.win_length, cfg.n_fft)
    mag = np.abs(np.fft.rfft(frames, n=cfg.n_fft, axis=-1)).astype(
        np.float32)
    fbank = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                           cfg.fmin, cfg.fmax_hz)
    mel = mag @ fbank.T
    db = 20.0 * np.log10(np.maximum(mel, _AMP_FLOOR))
    return np.clip((db - cfg.ref_db - cfg.min_db) / (-cfg.min_db),
                   0.0, 1.0).astype(np.float32)


# mu-law companding: the classic 8-bit WaveNet input path (the MoL teacher
# does not use it; part of the reference's DSP surface)


def mulaw_encode(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """x in [-1, 1] -> companded [-1, 1]."""
    mu_f = float(mu)
    return torch.sign(x) * torch.log1p(mu_f * torch.abs(x)) / np.log1p(mu_f)


def mulaw_decode(y: torch.Tensor, mu: int = 255) -> torch.Tensor:
    mu_f = float(mu)
    return torch.sign(y) * (torch.pow(1.0 + mu_f, torch.abs(y)) - 1.0) / mu_f


def mulaw_quantize(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """x in [-1, 1] -> integer class in [0, mu]."""
    y = mulaw_encode(x, mu)
    return torch.clamp((y + 1.0) / 2.0 * mu + 0.5, 0, mu).to(torch.int32)


def mulaw_dequantize(q: torch.Tensor, mu: int = 255) -> torch.Tensor:
    return mulaw_decode(2.0 * (q.to(torch.float32) / mu) - 1.0, mu)


# Griffin-Lim: phase reconstruction, a debugging utility


def _istft(spec: torch.Tensor, n_fft: int, hop: int, win_length: int,
           length: int) -> torch.Tensor:
    """Overlap-add inverse STFT of a complex (..., frames, n_fft//2+1),
    normalized by the summed squared window."""
    win = torch.from_numpy(hann_window(win_length, n_fft)).to(spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    n_frames = frames.shape[-2]
    total = n_fft + hop * (n_frames - 1)
    idx = (torch.arange(n_frames, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    flat = frames.reshape(-1, n_frames * n_fft)
    sig = torch.zeros(flat.shape[0], total, device=spec.device)
    sig.index_add_(1, idx, flat)
    wsum = torch.zeros(total, device=spec.device)
    wsum.index_add_(0, idx, torch.square(win).repeat(n_frames))
    out = (sig / torch.clamp(wsum, min=1e-8)).reshape(
        *spec.shape[:-2], total)
    start = n_fft // 2
    return out[..., start: start + length]


def griffin_lim(mag: torch.Tensor, cfg: DSPConfig, length: int,
                n_iters: int = 50, seed: int = 0,
                angles: torch.Tensor | None = None) -> torch.Tensor:
    """Phase reconstruction from a linear magnitude spectrogram (...,
    frames, n_fft//2+1).  The initial phases are `angles`, or uniform in
    [-pi, pi) from a generator seeded with `seed` on mag's device."""
    if angles is None:
        gen = torch.Generator(device=mag.device).manual_seed(seed)
        angles = (torch.rand(mag.shape, generator=gen, device=mag.device)
                  * 2.0 - 1.0) * np.pi
    spec = mag * torch.exp(1j * angles.to(torch.complex64))
    win = torch.from_numpy(hann_window(cfg.win_length, cfg.n_fft)).to(
        mag.device)
    for _ in range(n_iters):
        wav = _istft(spec, cfg.n_fft, cfg.hop_length, cfg.win_length, length)
        re_c = torch.fft.rfft(frame(wav, cfg.n_fft, cfg.hop_length) * win,
                              n=cfg.n_fft, dim=-1)
        spec = mag * (re_c / torch.clamp(torch.abs(re_c), min=1e-8))
    return _istft(spec, cfg.n_fft, cfg.hop_length, cfg.win_length, length)
