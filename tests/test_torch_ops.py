"""The PyTorch port's ops against the JAX reference: shifts, causal and
transposed convolutions, the logistic base, DSP and wav I/O.

Inputs come from a numpy seed and go through both functions.  Unless a
test says otherwise the tolerance is float32 rounding of a short sum
(1e-5 absolute on unit-scale values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pwn_tpu.config import get_config
from pwn_tpu.ops import conv as jconv
from pwn_tpu.ops import mol as jmol
from pwn_tpu.utils import audio_io as jaudio_io
from pwn_tpu.utils import dsp as jdsp
from pwn_tpu_torch.ops import conv, mol
from pwn_tpu_torch.utils import audio_io, dsp

DSP = get_config("tiny_teacher").dsp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it (measured ~60x slower
    than alone), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("amount", [0, 1, 5, 15, 16, 40])
def test_shift_right_matches_jax(rng, amount):
    """T = 16: amounts >= T are all padding."""
    x = _normal(rng, 2, 16, 3)
    got = conv.shift_right(torch.from_numpy(x), amount).numpy()
    want = np.asarray(jconv.shift_right(jnp.asarray(x), amount))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,dilation", [(1, 1), (2, 1), (2, 7), (2, 64)])
def test_causal_conv1d_matches_jax(rng, k, dilation):
    x = _normal(rng, 2, 50, 6)
    w = _normal(rng, k, 6, 5, scale=0.4)
    b = _normal(rng, 5)
    got = conv.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             dilation, torch.from_numpy(b)).numpy()
    want = np.asarray(jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                          dilation, jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_causal_conv1d_rejects_wide_kernels(rng):
    with pytest.raises(ValueError, match="kernel_size"):
        conv.causal_conv1d(torch.zeros(1, 4, 2), torch.zeros(3, 2, 2))


@pytest.mark.parametrize("stride,mult", [(8, 2), (16, 2), (4, 3)])
def test_conv_transpose1d_matches_jax(rng, stride, mult):
    x = _normal(rng, 2, 7, 5)
    w = _normal(rng, stride * mult, 5, 4, scale=0.3)
    b = _normal(rng, 4)
    got = conv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                stride, torch.from_numpy(b)).numpy()
    want = np.asarray(jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                             stride, jnp.asarray(b)))
    assert got.shape == (2, 7 * stride, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the kernel flip is what makes torch's scatter equal lax's correlation
    k = w.shape[0]
    unflipped = F.conv_transpose1d(
        torch.from_numpy(x).transpose(1, 2),
        torch.from_numpy(w).permute(1, 2, 0), stride=stride,
    )[:, :, (k - stride) // 2:][:, :, : 7 * stride].transpose(1, 2)
    assert np.abs(unflipped.numpy() + b - want).max() > 0.1


def test_sample_logistic_bounds_and_moments():
    """u is clipped to [1e-5, 1 - 1e-5], so |z| <= log((1-1e-5)/1e-5); the
    mean is 0 and the variance pi^2/3, as for the reference's draws (the
    bits differ: torch's generator is not jax.random)."""
    import jax

    bound = np.log((1 - 1e-5) / 1e-5)
    z = mol.sample_logistic(torch.Generator().manual_seed(0),
                            (200_000,)).numpy()
    zj = np.asarray(jmol.sample_logistic(jax.random.PRNGKey(0), (200_000,)))
    for draw in (z, zj):
        assert np.abs(draw).max() <= bound + 1e-4
        assert abs(draw.mean()) < 0.03
        assert abs(draw.var() / (np.pi ** 2 / 3) - 1) < 0.03
    assert z.dtype == np.float32


def test_logistic_log_density_matches_jax(rng):
    x = _normal(rng, 3, 64, scale=3.0)
    mean = _normal(rng, 3, 64)
    log_scale = _normal(rng, 3, 64, scale=0.5)
    got = mol.logistic_log_density(
        *(torch.from_numpy(a) for a in (x, mean, log_scale))).numpy()
    want = np.asarray(jmol.logistic_log_density(
        *(jnp.asarray(a) for a in (x, mean, log_scale))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_preemphasis_matches_jax(rng):
    x = _normal(rng, 2, 300)
    got = dsp.preemphasis(torch.from_numpy(x), 0.97).numpy()
    want = np.asarray(jdsp.preemphasis(jnp.asarray(x), 0.97))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mel_spectrogram_matches_jax_and_numpy(rng):
    """Against both reference pipelines, at their own mutual tolerance
    (tests/test_dsp.py): float32 FFTs in other orders, seen through the
    log and the [0, 1] dB normalisation."""
    t = np.arange(4096) / DSP.sample_rate
    x = (0.4 * np.sin(2 * np.pi * 440 * t)[None]
         + _normal(rng, 2, 4096, scale=0.05)).astype(np.float32)
    got = dsp.mel_spectrogram(torch.from_numpy(x), DSP).numpy()
    want = np.asarray(jdsp.mel_spectrogram(jnp.asarray(x), DSP))
    want_np = jdsp.mel_spectrogram_np(x, DSP)
    assert got.shape == want.shape == (2, 4096 // DSP.hop_length + 1,
                                       DSP.n_mels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got, want_np, rtol=1e-4, atol=2e-5)


def test_filterbank_and_window_are_the_reference_constants():
    args = (DSP.sample_rate, DSP.n_fft, DSP.n_mels, DSP.fmin, DSP.fmax_hz)
    np.testing.assert_array_equal(dsp.mel_filterbank(*args),
                                  jdsp.mel_filterbank(*args))
    np.testing.assert_array_equal(dsp.hann_window(400, 512),
                                  jdsp.hann_window(400, 512))


def test_wav_io_round_trip_matches_reference(tmp_path, rng):
    wav = np.clip(_normal(rng, 1600, scale=0.3), -1, 1)
    ours, theirs = tmp_path / "a.wav", tmp_path / "b.wav"
    audio_io.write_wav(str(ours), wav, 16000)
    jaudio_io.write_wav(str(theirs), wav, 16000)
    assert ours.read_bytes() == theirs.read_bytes()
    got, sr = audio_io.read_wav(str(ours), target_sr=8000)
    want, sr_j = jaudio_io.read_wav(str(ours), target_sr=8000)
    assert sr == sr_j == 8000
    np.testing.assert_array_equal(got, want)
