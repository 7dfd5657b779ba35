"""The port's copy-synthesis metrics (`pwn_tpu_torch/evaluate.py`) against
the JAX reference's (`pwn_tpu/evaluate.py`) on seeded wavs, on the CPU.

The wavs mix a voiced part (harmonics) with silence, so the voiced /
silent split and its floors are exercised, and the generated wav is one
frame longer than the reference for the frame clamp.
"""

import numpy as np
import pytest
import torch

from pwn_tpu import evaluate as jeval
from pwn_tpu_torch import evaluate, get_config
from torch_parity import jax_config

CFG = get_config("tiny_teacher")
SR = CFG.dsp.sample_rate


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(0)
    t = np.arange(int(0.5 * SR)) / SR
    voiced = sum(0.3 / h * np.sin(2 * np.pi * 180 * h * t) for h in range(1, 5))
    ref = np.concatenate([voiced, np.zeros(int(0.25 * SR))])
    ref = ref + 1e-4 * rng.standard_normal(ref.size)
    gen = ref * 0.8 + 0.02 * rng.standard_normal(ref.size)
    gen = np.concatenate([gen, rng.standard_normal(CFG.dsp.hop_length) * 0.1])
    return ref.astype(np.float32), gen.astype(np.float32)


@pytest.mark.parametrize("name", ["mel_l2", "spectral_convergence",
                                  "log_spectral_distance", "voiced_metrics"])
def test_metric_matches_jax(wavs, name):
    """float32 spectra on both sides; 1e-5 relative."""
    ref, gen = wavs
    got = getattr(evaluate, name)(CFG, ref, gen, device="cpu")
    want = getattr(jeval, name)(jax_config(CFG), ref, gen)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        assert 0.0 < got["voiced_fraction"] < 1.0
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_copy_synthesis_report_matches_jax(wavs):
    ref, gen = wavs
    got = evaluate.copy_synthesis_report(CFG, torch.from_numpy(ref), gen,
                                         device="cpu")
    want = jeval.copy_synthesis_report(jax_config(CFG), ref, gen)
    assert list(got) == list(want) and len(got) == 6
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the same wav scores zero distance
    same = evaluate.copy_synthesis_report(CFG, ref, ref, device="cpu")
    assert same["mel_l2"] == 0.0 and same["spectral_convergence"] == 0.0


def test_all_silent_reference_takes_the_floors():
    """No voiced frame: the voiced LSD divides by the floor of 1 frame, and
    a silent generated wav sits at the -160 dB noise floor."""
    z = np.zeros(4 * CFG.dsp.hop_length, np.float32)
    got = evaluate.voiced_metrics(CFG, z, z, device="cpu")
    want = jeval.voiced_metrics(jax_config(CFG), z, z)
    assert got == pytest.approx(want)
    assert got["voiced_fraction"] == 0.0
    assert got["silence_noise_floor_db"] == pytest.approx(-160.0)


def test_no_card_is_an_error_not_the_cpu(wavs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.mel_l2(CFG, *wavs)
