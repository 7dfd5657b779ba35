"""Host-side wav I/O (counterpart of `pwn_tpu/utils/audio_io.py`).

A copy rather than an import: `pwn_tpu.utils` imports its JAX DSP module
on package import.  All in-framework audio is float32 in [-1, 1]; files
are 16-bit PCM.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono waveform in [-1, 1], sample_rate).

    Resamples with a polyphase filter if target_sr differs.
    """
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if target_sr is not None and target_sr != sr:
        g = np.gcd(int(target_sr), int(sr))
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return wav, sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write float waveform in [-1, 1] as 16-bit PCM."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wav = np.asarray(wav, dtype=np.float32)
    peak = np.max(np.abs(wav))
    if peak > 1.0:
        wav = wav / peak
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """Float waveform in [-1, 1] -> in-memory 16-bit PCM RIFF bytes
    (TensorBoard audio summaries embed the encoded file)."""
    import io

    wav = np.asarray(wav, dtype=np.float32)
    peak = np.max(np.abs(wav)) if wav.size else 0.0
    if peak > 1.0:
        wav = wav / peak
    buf = io.BytesIO()
    wavfile.write(buf, sample_rate, (wav * 32767.0).astype(np.int16))
    return buf.getvalue()
