"""The port's teacher WaveNet against the JAX reference: the discretized
MoL likelihood, the frozen goldens of both heads (MoL and Gaussian), live
teacher forcing, the parameter bridge on the teacher trees, and the
stack-mode choice.

Parameters come from JAX's `init_teacher` through
`convert.params_from_flax`; inputs are the goldens' or come from a numpy
seed.
"""

import numpy as np
import pytest
import torch

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.ops import mol
from torch_parity import jax_config

GOLDEN = "tests/goldens/tiny_v1.npz"
GOLDEN_GAUSS = "tests/goldens/tiny_gaussian_v1.npz"
TINY = get_config("tiny_teacher")
TINY_GAUSS = override(override(TINY, "teacher.output", "gaussian"),
                      "student.base", "gaussian")


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
def jax_teacher():
    """(JAX model, its variables, the port's teacher with those params) at
    the tiny preset (fp32, 10 layers, C=64)."""
    jax = pytest.importorskip("jax")
    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher

    model, variables = jax_init_teacher(jax_config(TINY), jax.random.PRNGKey(0))
    port = TeacherWaveNet(TINY)
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return model, variables, port


def _mol_cases(rng):
    """x over the interior, at both edge bins and beyond them, against
    params with tiny scales (the cdf_delta underflow branch), clamped
    scales and ordinary ones."""
    K = 10
    x = np.concatenate([rng.uniform(-1, 1, 60), [-1.0, 1.0, -0.9995, 0.9995,
                                                 0.0, 0.5]]).astype(np.float32)
    params = rng.standard_normal((x.size, 3 * K)).astype(np.float32)
    params[:20, 2 * K:] = -8.5          # narrow: cdf_delta < 1e-5
    params[20:30, 2 * K:] = -12.0       # below log_scale_min: clamped
    params[:20, K:2 * K] = x[:20, None] + 0.01 * rng.standard_normal((20, K))
    return x, params


def test_discretized_mol_matches_jax(rng):
    """Log-prob per sample, fp32, within 1e-4 relative: the formulas are the
    same, but a bin's mass is the difference of two sigmoids, and where it
    is near the 1e-5 branch threshold one ulp of either sigmoid (6e-8) moves
    log(mass) by ~5e-5 relative (the largest gap seen).  The mean loss
    averages that out: 1e-5."""
    from pwn_tpu.ops import mol as jax_mol

    x, params = _mol_cases(rng)
    want = np.asarray(jax_mol.discretized_mol_log_prob(x, params))
    got = mol.discretized_mol_log_prob(torch.from_numpy(x),
                                       torch.from_numpy(params)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the branches are all taken: edges, underflow, ordinary bins
    logits, means, log_s = mol.split_params(torch.from_numpy(params))
    inv_s = torch.exp(-torch.clamp(log_s, min=-9.0))
    xc = torch.from_numpy(x)[:, None] - means
    delta = (torch.sigmoid(inv_s * (xc + 1 / 65535))
             - torch.sigmoid(inv_s * (xc - 1 / 65535)))
    assert (delta <= 1e-5).any() and (delta > 1e-5).any()
    assert (np.abs(x) > 0.999).sum() == 4
    loss = mol.discretized_mol_loss(torch.from_numpy(x),
                                    torch.from_numpy(params))
    np.testing.assert_allclose(
        float(loss), float(jax_mol.discretized_mol_loss(x, params)),
        rtol=1e-5)


def test_teacher_matches_goldens(jax_teacher):
    """The goldens' own gate (tests/test_goldens.py): MoL params within
    rtol 1e-4 / atol 1e-5 and the NLL within 1e-5 relative."""
    g = np.load(GOLDEN)
    from pwn_tpu_torch.utils import dsp

    _, _, port = jax_teacher
    wav = torch.from_numpy(g["clip"])[None]
    x = torch.clamp(dsp.preemphasis(wav, TINY.dsp.preemphasis), -1, 1)
    with torch.no_grad():
        params = port(x, torch.from_numpy(g["mel"])[None])
        nll = mol.discretized_mol_loss(
            x, params, log_scale_min=TINY.teacher.log_scale_min)
    np.testing.assert_allclose(params[0, :512].numpy(), g["teacher_mol"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(nll), float(g["teacher_nll"]),
                               rtol=1e-5)


def test_gaussian_teacher_matches_goldens():
    """The Gaussian head (teacher.output="gaussian", two units): the
    goldens' (mean, log_scale) params and continuous NLL at their own gate
    (tests/test_goldens.py: rtol 1e-4 / atol 1e-5, NLL 1e-5 relative),
    from the same init key as the MoL goldens."""
    import jax

    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher
    from pwn_tpu_torch.ops import gaussian
    from pwn_tpu_torch.utils import dsp

    g, gg = np.load(GOLDEN), np.load(GOLDEN_GAUSS)
    _, variables = jax_init_teacher(jax_config(TINY_GAUSS),
                                    jax.random.PRNGKey(0))
    port = TeacherWaveNet(TINY_GAUSS)
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    assert port.stack.head2.kernel.shape[-1] == 2
    wav = torch.from_numpy(g["clip"])[None]
    x = torch.clamp(dsp.preemphasis(wav, TINY.dsp.preemphasis), -1, 1)
    with torch.no_grad():
        params = port(x, torch.from_numpy(g["mel"])[None])
        nll = gaussian.gaussian_nll(
            x, params, log_scale_min=TINY.teacher.log_scale_min)
        loss = port.loss(x, torch.from_numpy(g["mel"])[None])
    assert params.shape[-1] == 2
    np.testing.assert_allclose(params[0, :512].numpy(), gg["teacher_gauss"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(nll), float(gg["teacher_nll"]),
                               rtol=1e-5)
    assert float(loss) == float(nll)


def test_teacher_forcing_and_loss_match_live_jax(jax_teacher, rng):
    """A two-row batch with a ragged length (T not frames * hop: the
    conditioning is edge-padded), params and loss, fp32 within 1e-4."""
    import jax.numpy as jnp

    model, variables, port = jax_teacher
    hop = TINY.dsp.hop_length
    wav = rng.uniform(-0.8, 0.8, (2, 7 * hop + 29)).astype(np.float32)
    mel = rng.uniform(0, 1, (2, 7, TINY.dsp.n_mels)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(wav), jnp.asarray(mel))
    want_loss = model.apply(variables, jnp.asarray(wav), jnp.asarray(mel),
                            method="loss")
    with torch.no_grad():
        got = port(torch.from_numpy(wav), torch.from_numpy(mel))
        loss = port.loss(torch.from_numpy(wav), torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_teacher_lj_tree_round_trip():
    """The full teacher_lj flax tree (upsample/kernel_i, stack/front,
    stack/layer_0..23, stack/head1, stack/head2) maps flax -> port -> flax
    unchanged."""
    _round_trip("teacher_lj", 30)


def test_clarinet_gaussian_tree_round_trip():
    """The same at clarinet_gaussian, whose teacher has the two-unit
    Gaussian head at teacher_lj widths."""
    _round_trip("clarinet_gaussian", 2)


def _round_trip(name, head_dim):
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.teacher import make_teacher as jax_make_teacher

    cfg = get_config(name)
    hop = cfg.dsp.hop_length
    shapes = jax.eval_shape(
        jax_make_teacher(jax_config(cfg)).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4 * hop)), jnp.zeros((1, 4, cfg.dsp.n_mels)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = convert.params_from_flax(tree)
    assert tuple(sd["stack.layer_23.w_dilated"].shape) == (2, 128, 256)
    assert tuple(sd["stack.head2.kernel"].shape) == (1, 128, head_dim)
    port = TeacherWaveNet(cfg)
    port.load_state_dict(sd, strict=True)
    back = convert.params_to_flax(port.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_init_teacher_is_seeded_and_fan_in_scaled():
    port = init_teacher(TINY, torch.Generator().manual_seed(0), device="cpu")
    sd = port.state_dict()
    for k, v in sd.items():
        if k.split(".")[-1].startswith("b"):
            assert not v.any(), k
    w = sd["stack.layer_0.w_dilated"]  # fan_in = 2 * 64
    assert abs(float(w.std()) * np.sqrt(128) - 1) < 0.05
    again = init_teacher(TINY, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again.state_dict(), sd, rtol=0, atol=0)


@pytest.mark.parametrize("flag,mode", [
    ("auto", "infer"), ("mega", "infer"), ("mega_train", "train"),
    ("mega_dx", "dx"),
])
def test_stack_mode_follows_the_config(flag, mode):
    """At student_iaf's widths (the tiny teacher with 80 mel bands), which
    kernel 1 and kernels 2 and 3 are built for, a training stack keeps its
    mode, as the reference's `mega_ok` keeps it on mega_train / mega_dx;
    at teacher_lj's widths too."""
    cfg = override(TINY, "dsp.n_mels", 80)
    port = TeacherWaveNet(override(cfg, "teacher.fused_layers", flag))
    assert port.stack.mode == mode
    assert TeacherWaveNet(cfg, stack_mode="train").stack.mode == "train"
    lj = override(override(get_config("teacher_lj"), "teacher.n_blocks", 1),
                  "teacher.layers_per_block", 2)
    assert TeacherWaveNet(lj, stack_mode="train").stack.mode == "train"


@pytest.mark.parametrize("key,value", [
    # the reference's XLA stack: once refused, now the per-layer kernel mode
    ("teacher.fused_layers", "off"),
])
def test_unported_variants_raise(key, value, rng):
    """`"off"` builds the teacher in mode "layer", and its loss and every
    gradient match jax.grad of the JAX package's "off" on the same
    converted weights at fp32: the loss within 1e-5 relative, each
    gradient within 2e-3 of its norm (the gate of
    tests/test_torch_gated_layer.py::test_teacher_trains_through_the_layer_kernel)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher
    from pwn_tpu.training.teacher import prepare_batch as jax_prepare
    from pwn_tpu_torch.training.teacher import prepare_batch

    cfg = override(override(TINY, key, value), "teacher.n_blocks", 1)
    jcfg = jax_config(cfg)
    model, variables = jax_init_teacher(jcfg, jax.random.PRNGKey(4),
                                        use_scan=False)
    port = TeacherWaveNet(cfg)
    assert port.stack.mode == "layer"
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    wav = rng.uniform(-0.6, 0.6, (2, 1024)).astype(np.float32)
    x, mel = jax_prepare(jnp.asarray(wav), jcfg)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: model.apply(
        {"params": p}, x, mel, method="loss")))(variables["params"])
    want = convert.params_from_flax(jax.tree.map(np.asarray, want))
    loss = port.loss(*prepare_batch(torch.from_numpy(wav), cfg))
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        assert float((g - want[n]).norm()) <= 2e-3 * float(want[n].norm()), n
