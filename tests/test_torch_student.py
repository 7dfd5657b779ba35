"""The port's student IAF against the JAX reference: the frozen goldens,
live generation on shared noise, and the parameter bridge.

Parameters come from JAX's `init_student` through `convert.params_from_flax`;
noise and mels are the goldens' or come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwn_tpu.models.student import init_student as jax_init_student
from pwn_tpu.models.student import make_student
from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.models.student import StudentIAF, init_student
from torch_parity import jax_config

GOLDEN = "tests/goldens/tiny_v1.npz"
TINY = get_config("tiny_teacher")
JTINY = jax_config(TINY)
STUDENT_IAF_PARAMS = 1_835_432


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
def tiny_pair():
    """(JAX model, JAX variables, port model) at the tiny preset, whose
    student has student_iaf's widths (4 flows x 10 layers, C=64) in fp32."""
    model, variables = jax_init_student(JTINY, jax.random.PRNGKey(1))
    port = StudentIAF(TINY)
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return model, variables, port


def test_transform_matches_goldens(tiny_pair):
    """fp32, 1e-4 absolute: the goldens' own gate (tests/test_goldens.py)
    for 40 float32 layers summed in another order."""
    g = np.load(GOLDEN)
    _, _, port = tiny_pair
    with torch.no_grad():
        out = port(torch.from_numpy(g["z"])[None],
                   torch.from_numpy(g["mel"])[None])
    np.testing.assert_allclose(out.wav[0].numpy(), g["student_wav"],
                               atol=1e-4)
    np.testing.assert_allclose(out.log_det[0].numpy(), g["student_log_det"],
                               atol=1e-4)


def test_transform_outputs_match_live_jax(tiny_pair, rng):
    """Every field of StudentOutput on fresh noise and a ragged mel (the
    upsampler's edge padding: T is not frames * hop)."""
    model, variables, port = tiny_pair
    hop = TINY.dsp.hop_length
    mel = rng.uniform(0, 1, (2, 9, TINY.dsp.n_mels)).astype(np.float32)
    z = rng.logistic(0, 1, (2, 9 * hop + 37)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(z), jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(mel))
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_generate_from_z_matches_live_jax(tiny_pair, rng):
    model, variables, port = tiny_pair
    hop = TINY.dsp.hop_length
    mel = rng.uniform(0, 1, (1, 12, TINY.dsp.n_mels)).astype(np.float32)
    z = rng.logistic(0, 1, (1, 12 * hop)).astype(np.float32) * 0.8
    want = model.apply(variables, jnp.asarray(z), jnp.asarray(mel),
                       method="generate_from_z")
    with torch.no_grad():
        got = port.generate_from_z(torch.from_numpy(z),
                                   torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(got.numpy()).max() <= 1.0


def test_stacked_is_the_jax_layout_transposed(tiny_pair):
    """`WaveNetStack.stacked()` holds the blocks of JAX's `_stacked`
    ([w_dilated[1]; w_dilated[0]; w_cond] and [w_res | w_skip]) stored
    (out, in); its biases are JAX's summed gate bias and [b_res | b_skip]."""
    from types import SimpleNamespace

    from pwn_tpu.models.modules import WaveNetStack as JaxStack

    _, variables, port = tiny_pair
    flow = variables["params"]["flow_0"]
    layers = [flow[f"layer_{i}"] for i in range(len(port.flow_0.dilations))]
    w_in, b_g, w_out, b_res, b_skip = JaxStack._stacked(
        SimpleNamespace(dtype=jnp.float32), layers)
    with torch.no_grad():
        got = port.flow_0.stacked()
    want = (np.swapaxes(w_in, 1, 2), b_g, np.swapaxes(w_out, 1, 2),
            np.concatenate([b_res, b_skip], axis=1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stacked_is_built_once_until_a_parameter_changes():
    """With grad off the stacked weights are reused; loading new weights
    rebuilds them; with grad on they are built fresh and keep the graph."""
    cfg = override(TINY, "student.n_flows", 1)
    port = init_student(cfg, torch.Generator().manual_seed(0), device="cpu")
    stack = port.flow_0
    with torch.no_grad():
        a, b = stack.stacked(), stack.stacked()
    assert all(x is y for x, y in zip(a, b))
    sd = {k: v + 1 for k, v in port.state_dict().items()}
    port.load_state_dict(sd)
    with torch.no_grad():
        c = stack.stacked()
    assert not torch.equal(a[0], c[0])
    torch.testing.assert_close(c[0][0, :, 0], sd["flow_0.layer_0.w_dilated"][1, 0])
    fresh = stack.stacked()
    assert fresh[0].requires_grad and fresh[0] is not c[0]
    with torch.inference_mode():
        d = stack.stacked()
    assert all(x is y for x, y in zip(c, d))


def test_student_iaf_tree_round_trip():
    """The full student_iaf tree (upsample kernels (32, 80, 80), four flows
    of front / ten layers / heads) maps flax -> port -> flax unchanged."""
    cfg = get_config("student_iaf")
    hop = cfg.dsp.hop_length
    shapes = jax.eval_shape(
        make_student(jax_config(cfg)).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4 * hop)), jnp.zeros((1, 4, cfg.dsp.n_mels)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = convert.params_from_flax(tree)
    assert sum(v.numel() for v in sd.values()) == STUDENT_IAF_PARAMS
    assert tuple(sd["upsample.kernel_0"].shape) == (32, 80, 80)
    assert tuple(sd["flow_3.layer_9.w_dilated"].shape) == (2, 64, 128)
    port = StudentIAF(cfg)
    port.load_state_dict(sd, strict=True)
    back = convert.params_to_flax(port.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_init_student_shapes_and_scale():
    """The port's own init: the flax shapes, zero biases, and fan-in
    truncated-normal kernels (std sqrt(1/fan_in))."""
    cfg = get_config("student_iaf")
    port = init_student(cfg, torch.Generator().manual_seed(0), device="cpu")
    sd = port.state_dict()
    assert sum(v.numel() for v in sd.values()) == STUDENT_IAF_PARAMS
    for k, v in sd.items():
        if k.split(".")[-1].startswith("b"):
            assert not v.any(), k
    w = sd["flow_0.layer_0.w_dilated"]  # fan_in = 2 * 64
    assert abs(float(w.std()) * np.sqrt(128) - 1) < 0.05
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / np.sqrt(128)
    again = init_student(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again.state_dict(), sd, rtol=0, atol=0)


def test_npz_round_trip(tmp_path, tiny_pair):
    _, _, port = tiny_pair
    path = tmp_path / "student.npz"
    convert.save_npz(str(path), port.state_dict())
    loaded = convert.load_npz(str(path))
    torch.testing.assert_close(loaded, dict(port.state_dict()), rtol=0,
                               atol=0)


@pytest.mark.parametrize("key,value", [
    # the reference's XLA stack: once refused, now the per-layer kernel mode
    ("student.fused_layers", "off"),
])
def test_unported_variants_raise(key, value, rng):
    """`"off"` builds every flow in mode "layer", and under autograd (the
    layers' custom backward) a loss of the transform's outputs and its
    gradient in every parameter match the JAX package's "off" on the same
    converted weights at fp32: the loss within 1e-5 relative, each
    gradient within 2e-3 of its norm (the gate of
    tests/test_torch_gated_layer.py::test_teacher_trains_through_the_layer_kernel)."""
    cfg = override(override(TINY, key, value), "student.n_flows", 2)
    model, variables = jax_init_student(jax_config(cfg),
                                        jax.random.PRNGKey(3), use_scan=False)
    port = StudentIAF(cfg)
    assert [f.mode for f in port.flows] == ["layer", "layer"]
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    hop = cfg.dsp.hop_length
    mel = rng.uniform(0, 1, (2, 6, cfg.dsp.n_mels)).astype(np.float32)
    z = rng.logistic(0, 1, (2, 6 * hop)).astype(np.float32)

    def loss_of(out, mean):
        return mean(out.log_p_student) + mean(out.wav * out.mu_total)

    want_loss, want = jax.jit(jax.value_and_grad(lambda p: loss_of(
        model.apply({"params": p}, jnp.asarray(z), jnp.asarray(mel)),
        jnp.mean)))(variables["params"])
    want = convert.params_from_flax(jax.tree.map(np.asarray, want))
    loss = loss_of(port(torch.from_numpy(z), torch.from_numpy(mel)),
                   torch.mean)
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        assert float((g - want[n]).norm()) <= 2e-3 * float(want[n].norm()), n


@pytest.mark.parametrize("kernel_size", [1, 3])
def test_kernel_size_other_than_two_raises(kernel_size):
    """`student.kernel_size` reaches the flows, as the reference's
    `WaveNetStack` takes it and refuses anything but 2: never run as K=2."""
    with pytest.raises(NotImplementedError, match="kernel_size=2"):
        StudentIAF(override(TINY, "student.kernel_size", kernel_size))
    assert StudentIAF(override(TINY, "student.kernel_size", 2)).flows


@pytest.mark.parametrize("flag,mode", [
    ("auto", "infer"), ("mega", "infer"), ("on", "layer"),
    ("layer", "layer"), ("mega_train", "train"), ("mega_dx", "dx"),
])
def test_fused_layers_flag_reaches_every_flow(flag, mode):
    """`student.fused_layers` sets every flow's stack mode, at student_iaf's
    widths, which kernel 1 takes for inference and kernels 2 and 3 for
    training: mega_train and mega_dx keep their modes, as the reference's
    `mega_ok` keeps such a stack on its whole-stack training kernels."""
    port = StudentIAF(override(get_config("student_iaf"),
                               "student.fused_layers", flag))
    assert [f.mode for f in port.flows] == [mode] * 4
