"""The port's normalization ops (`ops/norm.py`) and the weight-normed
upsampler against the JAX reference, on the CPU at tiny fp32 sizes: the
functions, the modules fed the flax parameters through
`convert.params_from_flax`, a teacher and a student with
`teacher.upsample_weight_norm=True`, and the initial kernel equal to v.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.models.modules import UpsampleNet
from pwn_tpu_torch.models.student import StudentIAF, init_student
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.ops import norm
from torch_parity import jax_config

# tiny_teacher's DSP (40 mels, hop 128, two upsampler stages) with a
# 3-layer teacher and a 2 x 3-layer student at C=16, the upsampler
# weight-normed
TINY_WN = get_config("tiny_teacher")
for _k, _v in {"teacher.upsample_weight_norm": True,
               "student.n_flows": 2, "student.layers_per_flow": 3,
               "student.residual_channels": 16, "student.gate_channels": 32,
               "student.skip_channels": 16, "teacher.n_blocks": 1,
               "teacher.layers_per_block": 3,
               "teacher.residual_channels": 16, "teacher.gate_channels": 32,
               "teacher.skip_channels": 16, "teacher.n_mixtures": 4}.items():
    TINY_WN = override(TINY_WN, _k, _v)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it, so these tests run
    torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return convert.params_from_flax(jax.tree.map(np.asarray, tree))


def _x(seed=0, shape=(2, 37, 6)):
    """Activations of unit scale, offset from zero (instance norm's mean)."""
    return np.random.default_rng(seed).uniform(-0.8, 1.2, shape).astype(
        np.float32)


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(affine):
    """Over time per (batch, channel), the biased variance: 1e-6 absolute."""
    from pwn_tpu.ops.norm import instance_norm as jax_instance_norm

    x = _x()
    rng = np.random.default_rng(1)
    gb = ([rng.normal(size=6).astype(np.float32) for _ in range(2)]
          if affine else [None, None])
    want = jax_instance_norm(jnp.asarray(x), *(
        None if a is None else jnp.asarray(a) for a in gb))
    got = norm.instance_norm(torch.from_numpy(x), *(
        None if a is None else torch.from_numpy(a) for a in gb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_weight_norm_matches_jax():
    """g * v / ||v|| per output channel, one channel of v all zeros (the
    eps floor): 1e-6 absolute."""
    from pwn_tpu.ops.norm import weight_norm as jax_weight_norm

    rng = np.random.default_rng(2)
    v = rng.normal(size=(3, 5, 7)).astype(np.float32)
    v[..., 4] = 0.0
    g = rng.normal(size=7).astype(np.float32)
    want = jax_weight_norm(jnp.asarray(v), jnp.asarray(g))
    got = norm.weight_norm(torch.from_numpy(v), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert np.all(got.numpy()[..., 4] == 0.0)


@pytest.mark.parametrize("kernel_size,dilation", [(1, 1), (2, 3)])
def test_weight_norm_conv_matches_jax(kernel_size, dilation):
    """The module fed flax's parameters (g moved off ||v||): 1e-6
    absolute; and at its own init the kernel is v exactly."""
    from pwn_tpu.ops.norm import WeightNormConv1d as JaxConv

    x = _x(3)
    jmod = JaxConv(features=5, kernel_size=kernel_size, dilation=dilation)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {**params, "g": params["g"] * 1.7}
    want = jmod.apply({"params": params}, jnp.asarray(x))
    mod = norm.WeightNormConv1d(6, 5, kernel_size, dilation)
    mod.load_state_dict(_flat(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)

    mod.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(norm.weight_norm(mod.v, mod.g), mod.v)
    assert torch.count_nonzero(mod.bias) == 0


def test_instance_norm_module_matches_jax():
    """Learned gamma and beta from the flax tree: 1e-6 absolute; the
    port's init is gamma ones, beta zeros, as flax's."""
    from pwn_tpu.ops.norm import InstanceNorm as JaxInstanceNorm

    x = _x(4)
    jmod = JaxInstanceNorm()
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    fresh = norm.InstanceNorm(6)
    torch.testing.assert_close(dict(fresh.state_dict()), _flat(params),
                               rtol=0, atol=0)
    rng = np.random.default_rng(5)
    params = {k: jnp.asarray(rng.normal(size=6).astype(np.float32))
              for k in ("gamma", "beta")}
    want = jmod.apply({"params": params}, jnp.asarray(x))
    fresh.load_state_dict(_flat(params))
    with torch.no_grad():
        got = fresh(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_weight_normed_upsampler_matches_jax():
    """`UpsampleNet(weight_norm=True)` holds v_i, g_i and bias_i under the
    reference's names and matches its output within 1e-5 absolute (fp32,
    two transposed convs); the kernel the forward builds at the port's own
    init is v exactly, and so is the upsampler's output to the plain one's
    on kernel_i = v_i."""
    from pwn_tpu.models.modules import UpsampleNet as JaxUpsample

    tc = TINY_WN.teacher
    M = TINY_WN.dsp.n_mels
    mel = np.random.default_rng(6).uniform(0, 1, (2, 5, M)).astype(np.float32)
    jmod = JaxUpsample(strides=tc.upsample_strides, channels=M,
                       kernel_mult=tc.upsample_kernel_mult, weight_norm=True)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"]
    rng = np.random.default_rng(7)
    params = {k: (v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                  if k.startswith("g_") else v) for k, v in params.items()}
    want = jmod.apply({"params": params}, jnp.asarray(mel))
    mod = UpsampleNet(tc.upsample_strides, M, M, tc.upsample_kernel_mult,
                      weight_norm=True)
    assert sorted(mod.state_dict()) == sorted(_flat(params))
    mod.load_state_dict(_flat(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    mod.reset_parameters(torch.Generator().manual_seed(1))
    plain = UpsampleNet(tc.upsample_strides, M, M, tc.upsample_kernel_mult)
    plain.load_state_dict({k.replace("v_", "kernel_"): v for k, v in
                           mod.state_dict().items() if not k.startswith("g_")})
    for i in range(len(tc.upsample_strides)):
        assert torch.equal(mod.kernel(i), getattr(mod, f"v_{i}"))
    with torch.no_grad():
        assert torch.equal(mod(torch.from_numpy(mel)),
                           plain(torch.from_numpy(mel)))


def test_weight_normed_teacher_matches_jax():
    """A teacher with `teacher.upsample_weight_norm=True` fed JAX's tree:
    head params within the teacher test's fp32 tolerance (1e-4) and the
    NLL within 1e-5 relative; `init_teacher` draws the same tree shape."""
    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher

    model, variables = jax_init_teacher(jax_config(TINY_WN),
                                        jax.random.PRNGKey(0))
    port = TeacherWaveNet(TINY_WN)
    flat = _flat(variables)
    assert "upsample.g_0" in flat and "upsample.kernel_0" not in flat
    port.load_state_dict(flat)
    hop = TINY_WN.dsp.hop_length
    rng = np.random.default_rng(8)
    wav = rng.uniform(-0.8, 0.8, (2, 6 * hop)).astype(np.float32)
    mel = rng.uniform(0, 1, (2, 6, TINY_WN.dsp.n_mels)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(wav), jnp.asarray(mel))
    want_loss = model.apply(variables, jnp.asarray(wav), jnp.asarray(mel),
                            method="loss")
    with torch.no_grad():
        got = port(torch.from_numpy(wav), torch.from_numpy(mel))
        loss = port.loss(torch.from_numpy(wav), torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    mine = init_teacher(TINY_WN, torch.Generator().manual_seed(0),
                        device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.state_dict().items()} == {
        k: tuple(v.shape) for k, v in flat.items()}


def test_weight_normed_student_matches_jax():
    """A student with the weight-normed upsampler fed JAX's tree, on shared
    z: the waveform and log-det within the student test's fp32 tolerance
    (1e-4); `init_student` draws the same tree shape."""
    from pwn_tpu.models.student import init_student as jax_init_student

    model, variables = jax_init_student(jax_config(TINY_WN),
                                        jax.random.PRNGKey(1))
    port = StudentIAF(TINY_WN)
    flat = _flat(variables)
    port.load_state_dict(flat)
    hop = TINY_WN.dsp.hop_length
    rng = np.random.default_rng(9)
    z = rng.logistic(size=(2, 5 * hop)).astype(np.float32)
    mel = rng.uniform(0, 1, (2, 5, TINY_WN.dsp.n_mels)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(z), jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(mel))
    np.testing.assert_allclose(got.wav.numpy(), np.asarray(want.wav),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.log_det.numpy(), np.asarray(want.log_det),
                               rtol=1e-4, atol=1e-4)
    mine = init_student(TINY_WN, torch.Generator().manual_seed(0),
                        device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.state_dict().items()} == {
        k: tuple(v.shape) for k, v in flat.items()}
