"""The PyTorch port's ops against the JAX reference: shifts, causal,
single-step and transposed convolutions, the logistic base, the MoL and
Gaussian samplers, the Gaussian head's densities, DSP and wav I/O.

Inputs come from a numpy seed and go through both functions.  Unless a
test says otherwise the tolerance is float32 rounding of a short sum
(1e-5 absolute on unit-scale values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pwn_tpu.ops import conv as jconv
from pwn_tpu.ops import gaussian as jgaussian
from pwn_tpu.ops import mol as jmol
from pwn_tpu.utils import audio_io as jaudio_io
from pwn_tpu.utils import dsp as jdsp
from pwn_tpu_torch import get_config
from pwn_tpu_torch.ops import conv, gaussian, mol
from pwn_tpu_torch.utils import audio_io, dsp
from torch_parity import jax_config

DSP = get_config("tiny_teacher").dsp
JDSP = jax_config(get_config("tiny_teacher")).dsp


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


@pytest.mark.parametrize("t", [0, 3, 4, 17, 63])
def test_conv1d_step_matches_jax_and_the_full_conv(rng, t):
    """One Fast-WaveNet step equals the reference's step and the full causal
    conv at t (dilation 4: t < 4 reads the zero history)."""
    B, T, C, O, d = 2, 64, 8, 12, 4
    x = _normal(rng, B, T, C)
    w = _normal(rng, 2, C, O, scale=0.4)
    b = _normal(rng, O)
    tap = x[:, t - d] if t >= d else np.zeros((B, C), np.float32)
    got = conv.conv1d_step(*(torch.from_numpy(a) for a in (tap, x[:, t], w, b)))
    want = np.asarray(jconv.conv1d_step(*(jnp.asarray(a)
                                          for a in (tap, x[:, t], w, b))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    full = conv.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), d,
                              torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), full[:, t].numpy(), rtol=1e-5,
                               atol=1e-5)
    no_bias = conv.conv1d_step(torch.from_numpy(tap), torch.from_numpy(x[:, t]),
                               torch.from_numpy(w))
    np.testing.assert_allclose(no_bias.numpy() + b, want, rtol=1e-5, atol=1e-5)


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


def test_sample_from_mol_component_frequencies_and_moments():
    """Three well-separated narrow components with weights 0.2/0.3/0.5: the
    share of draws near each mean is its weight, and each cluster's spread
    is the logistic's (scale e^-4, std pi/sqrt(3) e^-4), for the port's
    generator as for jax.random (the bits differ).  Everything stays in
    [-1, 1]; at temperature 0 a draw is its component's mean."""
    import jax

    n, probs, means = 200_000, np.array([0.2, 0.3, 0.5]), [-0.5, 0.1, 0.6]
    params = np.concatenate([np.log(probs), means, [-4.0] * 3]).astype(
        np.float32)
    params = np.broadcast_to(params, (n, 9))
    x = mol.sample_from_mol(torch.Generator().manual_seed(0),
                            torch.from_numpy(params.copy())).numpy()
    xj = np.asarray(jmol.sample_from_mol(jax.random.PRNGKey(0),
                                         jnp.asarray(params)))
    for draw in (x, xj):
        assert draw.shape == (n,) and np.abs(draw).max() <= 1.0
        near = np.abs(draw[:, None] - np.array(means)) < 0.2
        np.testing.assert_allclose(near.mean(0), probs, atol=0.006)
        spread = (draw[near[:, 2]] - means[2]).std()
        np.testing.assert_allclose(spread, np.pi / np.sqrt(3) * np.exp(-4.0),
                                   rtol=0.03)
    cold = mol.sample_from_mol(torch.Generator().manual_seed(1),
                               torch.from_numpy(params[:1000].copy()),
                               temperature=0.0).numpy()
    assert set(np.unique(cold)) <= {np.float32(m) for m in means}
    wide = np.array([[0.0, 0.95, 0.0]], np.float32)  # K=1, scale 1: clipped
    clip = mol.sample_from_mol(torch.Generator().manual_seed(2),
                               torch.from_numpy(np.repeat(wide, 5000, 0)))
    assert clip.abs().max() <= 1.0 and (clip == 1.0).any()


def test_gaussian_densities_match_jax(rng):
    """split_params, the log density, the NLL with its log-scale floor and
    the closed-form KL, elementwise against the reference."""
    x = _normal(rng, 3, 64, scale=0.5)
    params = np.stack([_normal(rng, 3, 64, scale=0.3),
                       _normal(rng, 3, 64, scale=2.0) - 3.0], -1)
    tp, jp = torch.from_numpy(params), jnp.asarray(params)
    for got, want in zip(gaussian.split_params(tp), jgaussian.split_params(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mean, log_s = (torch.from_numpy(np.ascontiguousarray(params[..., i]))
                   for i in (0, 1))
    np.testing.assert_allclose(
        gaussian.gaussian_log_density(torch.from_numpy(x), mean, log_s).numpy(),
        np.asarray(jgaussian.gaussian_log_density(
            jnp.asarray(x), jnp.asarray(mean.numpy()),
            jnp.asarray(log_s.numpy()))), rtol=1e-5, atol=1e-5)
    for floor in (-9.0, -3.0):
        np.testing.assert_allclose(
            float(gaussian.gaussian_nll(torch.from_numpy(x), tp, floor)),
            float(jgaussian.gaussian_nll(jnp.asarray(x), jp, floor)),
            rtol=1e-6)
    q, p = (_normal(rng, 4, 32) for _ in range(2))
    ls_q, ls_p = (_normal(rng, 4, 32, scale=0.7) for _ in range(2))
    np.testing.assert_allclose(
        gaussian.kl_gaussian(*(torch.from_numpy(a)
                               for a in (q, ls_q, p, ls_p))).numpy(),
        np.asarray(jgaussian.kl_gaussian(*(jnp.asarray(a)
                                           for a in (q, ls_q, p, ls_p)))),
        rtol=1e-5, atol=1e-5)
    assert abs(float(gaussian.kl_gaussian(*(torch.tensor(v) for v in
                                            (0.4, -1.1, 0.4, -1.1))))) < 1e-7


def test_gaussian_samplers_match_jax_and_moments(rng):
    """`sample_from_normals` on pre-drawn normals equals the reference
    (floor and clip included); `sample_from_gaussian` and `sample_normal`
    draw from the port's generator with the reference's moments."""
    import jax

    params = np.stack([_normal(rng, 50, scale=0.6),
                       _normal(rng, 50, scale=3.0) - 2.0], -1)
    eps = _normal(rng, 50)
    for floor, temp in ((-9.0, 1.0), (-2.5, 0.5)):
        got = gaussian.sample_from_normals(torch.from_numpy(params),
                                           torch.from_numpy(eps), floor, temp)
        want = jgaussian.sample_from_normals(jnp.asarray(params),
                                             jnp.asarray(eps), floor, temp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    n = 50_000
    flat = np.broadcast_to(np.float32([0.2, -2.0]), (n, 2)).copy()
    x = gaussian.sample_from_gaussian(torch.Generator().manual_seed(13),
                                      torch.from_numpy(flat)).numpy()
    xj = np.asarray(jgaussian.sample_from_gaussian(jax.random.PRNGKey(13),
                                                   jnp.asarray(flat)))
    for draw in (x, xj):
        assert abs(draw.mean() - 0.2) < 5e-3
        assert abs(draw.std() - np.exp(-2.0)) < 5e-3
    z = gaussian.sample_normal(torch.Generator().manual_seed(1), (n,))
    assert z.dtype == torch.float32 and z.shape == (n,)
    assert abs(z.mean().item()) < 0.02 and abs(z.std().item() - 1) < 0.02


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
    want = np.asarray(jdsp.mel_spectrogram(jnp.asarray(x), JDSP))
    want_np = jdsp.mel_spectrogram_np(x, JDSP)
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
