"""The port's generation entry points against the JAX reference.

`vocode_many` must give each item exactly the documented per-item result
(`pwn_tpu/generate.py` `vocode_many`): `generate_from_z` on the item's own
noise at its true length, deemphasized on the host.  torch's random
numbers are not jax.random's, so the noise is passed explicitly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwn_tpu.generate import _host_deemphasis
from pwn_tpu.generate import coerce_mel as jax_coerce_mel
from pwn_tpu.generate import mel_from_wav as jax_mel_from_wav
from pwn_tpu.models.student import init_student as jax_init_student
from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.generate import (coerce_mel, generate_student,
                                    mel_from_wav, vocode_many)
from pwn_tpu_torch.models.student import StudentIAF
from torch_parity import jax_config

CFG = get_config("tiny_teacher")
# the reference's XLA stack ("off"; the port has no counterpart to it)
JCFG = jax_config(override(CFG, "student.fused_layers", "off"))
HOP = CFG.dsp.hop_length
# 8 frames is under W = 2H+4 = 16 (the per-item upsample path); 21 and 37
# take the bucket-padded upsample + tail splice
LENGTHS = [8, 21, 37]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it (measured ~60x slower
    than alone), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """JAX and port students sharing parameters, every parameter jittered:
    fresh inits have zero biases, which would make bucket-padded
    upsampling trivially exact and leave the tail splice untested."""
    model, variables = jax_init_student(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(99)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), variables["params"])
    port = StudentIAF(CFG)
    port.load_state_dict(convert.params_from_flax(params))
    return model, params, port


@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(5)
    mels = [rng.uniform(0, 1, (F, CFG.dsp.n_mels)).astype(np.float32)
            for F in LENGTHS]
    zs = [rng.logistic(0, 1, F * HOP).astype(np.float32) for F in LENGTHS]
    return mels, zs


def test_vocode_many_matches_jax_per_item(models, items):
    """Ragged groups of a batch of 2 over three buckets.  Tolerance 2e-4,
    the reference's own bound for this comparison
    (tests/test_streaming.py): float32 reordering through 4 flows of
    exp(log_s) and the deemphasis IIR."""
    model, params, port = models
    mels, zs = items
    outs = vocode_many(CFG, port, mels, temperature=0.9, batch_size=2,
                       bucket_frames=8, z=zs)
    for F, m, z, out in zip(LENGTHS, mels, zs, outs):
        ref = model.apply({"params": params}, jnp.asarray(z[None]) * 0.9,
                          jnp.asarray(m[None]), method="generate_from_z")
        ref = _host_deemphasis(np.asarray(ref), CFG.dsp.preemphasis)[0]
        assert out.shape == (F * HOP,)
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("noise", ["seeded", "explicit"])
def test_vocode_many_same_output_at_batch_1_and_3(models, items, noise):
    """An item's audio depends only on its mel and its noise, not on the
    batch it lands in: the noise stream is seeded by (seed, item index).
    1e-5: the same float32 math at other GEMM shapes."""
    _, _, port = models
    mels, zs = items
    z = zs if noise == "explicit" else None
    # one 40-frame bucket holds all three items: one batch of 3 vs three of 1
    one = vocode_many(CFG, port, mels, seed=3, batch_size=1,
                      bucket_frames=40, z=z)
    three = vocode_many(CFG, port, mels, seed=3, batch_size=3,
                        bucket_frames=40, z=z)
    for a, b in zip(one, three):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert np.abs(one[0]).max() > 0


def test_generate_student_matches_jax(models, items):
    model, params, port = models
    mels, zs = items
    m, z = mels[1], zs[1]
    got = generate_student(CFG, port, m[None], z=torch.from_numpy(z[None]),
                           temperature=0.7)
    ref = model.apply({"params": params}, jnp.asarray(z[None]) * 0.7,
                      jnp.asarray(m[None]), method="generate_from_z")
    ref = _host_deemphasis(np.asarray(ref), CFG.dsp.preemphasis)[0]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    seeded = generate_student(CFG, port, m[None],
                              torch.Generator().manual_seed(0))
    assert seeded.shape == (m.shape[0] * HOP,) and np.isfinite(seeded).all()


def test_mel_from_wav_matches_jax(rng):
    """Mutual tolerance of the reference's two mel pipelines
    (tests/test_dsp.py)."""
    wav = np.clip(rng.standard_normal(3000) * 0.3, -1, 1).astype(np.float32)
    got = mel_from_wav(CFG, wav, device="cpu").numpy()
    want = np.asarray(jax_mel_from_wav(JCFG, wav))
    assert got.shape == want.shape == (1, 3000 // HOP, CFG.dsp.n_mels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(10,), (2, 10, 40), (10, 39),
                                   (1, 10, 41), (1, 1, 10, 40)])
def test_coerce_mel_rejects_bad_shapes(shape):
    bad = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="mel must be"):
        coerce_mel(CFG, bad)
    with pytest.raises(ValueError, match="mel must be"):
        jax_coerce_mel(JCFG, bad)


def test_coerce_mel_accepts_and_rejects_like_jax():
    mel = np.random.default_rng(0).uniform(0, 1, (7, 40)).astype(np.float32)
    np.testing.assert_array_equal(coerce_mel(CFG, mel),
                                  jax_coerce_mel(JCFG, mel))
    np.testing.assert_array_equal(coerce_mel(CFG, torch.from_numpy(mel)),
                                  mel[None])
    mel[3, 4] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        coerce_mel(CFG, mel)
