"""The port's teacher training against the JAX reference: data batches,
the optimizer's steps, tiny_teacher train steps, the loop on the CPU, the
weight-layout cache after an update, and — on a CUDA card only — the loop
through the training kernels.

JAX is imported inside the tests and fixtures that need it, so the CUDA
cases also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_training.py
"""

import numpy as np
import pytest
import torch

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.data import pipeline
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.ops import flow_stack as fs
from pwn_tpu_torch.ops.gated_layer import gated_layer
from pwn_tpu_torch.training.common import (ClippedAdam, create_train_state,
                                           global_norm)
from pwn_tpu_torch.training.loop import make_val_batch, run_teacher_training
from pwn_tpu_torch.training.teacher import make_teacher_train_step
from torch_parity import jax_config

TINY = override(get_config("tiny_teacher"), "train.crop_samples", 2048)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it (measured ~60x slower
    than alone), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda()


@pytest.mark.parametrize("corpus", ["tones", "speech"])
def test_batches_equal_the_reference_bit_for_bit(corpus):
    """Same corpus seed, iterator seed and start step: identical float32
    crops, and the held-out batch too."""
    from pwn_tpu import data as jax_data
    from pwn_tpu.training.loop import make_val_batch as jax_val_batch

    cfg = override(TINY, "train.synthetic_corpus", corpus)
    cls, jax_cls = {"tones": (pipeline.SyntheticTones,
                              jax_data.SyntheticTones),
                    "speech": (pipeline.SyntheticSpeech,
                               jax_data.SyntheticSpeech)}[corpus]
    kw = dict(n_clips=5, n_samples=3000, sample_rate=16000, seed=3)
    ours = pipeline.make_train_iterator(cls(**kw), cfg, 3, seed=11,
                                        start_step=4)
    ref = jax_data.make_train_iterator(jax_cls(**kw), jax_config(cfg), 3, seed=11,
                                       start_step=4)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(make_val_batch(cfg, None, 2),
                                  jax_val_batch(jax_config(cfg), None, 2))


def test_prefetch_stops_its_thread():
    it = pipeline.prefetch(iter(range(100)), put=lambda b: b * 2)
    assert [next(it) for _ in range(3)] == [0, 2, 4]
    it.close()


def test_optimizer_steps_equal_optax():
    """Three steps of clip -> adam -> decaying lr on float32 leaves, the
    second with a gradient over the clip norm: 1e-6 relative (float
    rounding of the same formulas)."""
    import jax.numpy as jnp

    from pwn_tpu.training.common import make_optimizer

    full = override(TINY, "train.lr_decay_steps", 3)
    cfg = full.train
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.5, 20.0, 0.1)]
    tx = make_optimizer(jax_config(full).train)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    ours = ClippedAdam(cfg)
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    ost = ours.init(tp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = {k: jp[k] + upd[k] for k in shapes}
        ours.update(tp, [torch.from_numpy(g[k]) for k in shapes], ost)
        for k, t in zip(shapes, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert float(global_norm([torch.from_numpy(v) for v in grads[1].values()])) > 10
    assert ours.learning_rate(0) == cfg.learning_rate


def _tiny_pair():
    import jax

    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher
    from pwn_tpu.training.common import create_train_state as jax_state
    from pwn_tpu.training.teacher import make_teacher_train_step as jax_step

    jtiny = jax_config(TINY)
    model, variables = jax_init_teacher(jtiny, jax.random.PRNGKey(0),
                                        use_scan=False)
    port = TeacherWaveNet(TINY, stack_mode="train")
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return (jax_state(variables["params"], jtiny.train),
            jax_step(model, jtiny), port)


def test_teacher_gradients_match_jax():
    """fp32 tiny_teacher, one batch of two 2048-sample crops: the port's
    loss and every parameter's gradient through the "train" stack (the
    plain versions of kernels 2 and 3) against jax.grad on the CPU.  Loss
    within 1e-5 relative; each gradient within 2e-3 of its norm (largest
    gap 1.1e-3, in the upsampler; 2e-4 to 3.5e-4 in the stack).  The MoL
    likelihood's gradient runs through log(sigmoid(a) - sigmoid(b)) over
    bins 2/65535 wide, whose derivative cancels to ~1e-5 of its terms, so
    the fp32 rounding, which the two frameworks do differently, leaves that
    much noise in every gradient."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher
    from pwn_tpu.training.teacher import prepare_batch as jax_prepare

    from pwn_tpu_torch.training.teacher import prepare_batch

    jtiny = jax_config(TINY)
    model, variables = jax_init_teacher(jtiny, jax.random.PRNGKey(0),
                                        use_scan=False)
    port = TeacherWaveNet(TINY, stack_mode="train")
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    wav = np.random.default_rng(1).uniform(-0.6, 0.6, (2, 2048)).astype(
        np.float32)
    x, mel = jax_prepare(jnp.asarray(wav), jtiny)
    loss, grads = jax.value_and_grad(lambda p: model.apply(
        {"params": p}, x, mel, method="loss"))(variables["params"])
    want = convert.params_from_flax(jax.tree.map(np.asarray, grads))
    got_loss = port.loss(*prepare_batch(torch.from_numpy(wav), TINY))
    names, params = zip(*port.named_parameters())
    got = torch.autograd.grad(got_loss, params)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=1e-5)
    assert set(names) == set(want)
    for k, g in zip(names, got):
        assert float((g - want[k]).norm()) <= 2e-3 * float(want[k].norm()), k
    # the top layer's residual output is unused: exactly zero in both
    assert not got[names.index("stack.layer_9.w_res")].any()


def test_teacher_train_steps_match_jax():
    """Two fp32 tiny_teacher steps against JAX's train step on the CPU.
    The loss of each step within 1e-5 relative (it shows the first update
    landed where JAX's did) and the grad norm within 1e-3 (gaps 1e-5 and
    1.6e-4).  Each parameter's two-step update within 5e-2 of its norm:
    Adam's first steps are ~lr * sign(g), which turns the gradients' fp32
    noise (test_teacher_gradients_match_jax) into sign flips of the
    smallest elements (largest gap 3.4%, in the upsampler)."""
    import jax

    jstate, jstep, port = _tiny_pair()
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    state = create_train_state(dict(port.named_parameters()), TINY.train)
    step = make_teacher_train_step(port, TINY)
    wav = np.random.default_rng(1).uniform(-0.6, 0.6, (2, 2048)).astype(
        np.float32)
    for _ in range(2):
        jstate, jm = jstep(jstate, jax.numpy.asarray(wav))
        state, m = step(state, torch.from_numpy(wav))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params))
    assert state.step == 2 and int(jstate.step) == 2
    for k, p in port.named_parameters():
        moved, ref = p.detach() - before[k], want[k] - before[k]
        assert float((moved - ref).norm()) <= 5e-2 * float(ref.norm()), k


def test_run_teacher_training_on_cpu():
    """The loop end to end on CPU tensors (plain versions): two steps, the
    held-out eval at the last, finite metrics; a data_dir without wav
    files raises, as the reference's."""
    res = run_teacher_training(TINY, num_steps=2, device="cpu")
    assert res.steps_run == 2 and res.state.step == 2
    assert set(res.final_metrics) == {"loss", "grad_norm", "val_loss"}
    assert all(np.isfinite(v) for v in res.final_metrics.values())
    with pytest.raises(FileNotFoundError, match="no .wav files under wavs"):
        run_teacher_training(TINY, data_dir="wavs", num_steps=1,
                             device="cpu")


def _cache_after_update(device):
    """One optimizer step between two no-grad uses of `stacked()`: the
    cached layout must equal a fresh build from the updated parameters."""
    cfg = override(get_config("teacher_lj"), "train.crop_samples", 2048)
    if device.type == "cpu":
        cfg = override(override(cfg, "teacher.n_blocks", 1),
                       "teacher.layers_per_block", 3)
    model = init_teacher(cfg, torch.Generator().manual_seed(0),
                         stack_mode="train", device=device)
    stack = model.stack
    with torch.no_grad():
        old = stack.stacked()
    state = create_train_state(dict(model.named_parameters()), cfg.train)
    wav = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.5, 0.5, (2, 2048)).astype(np.float32)).to(device)
    make_teacher_train_step(model, cfg)(state, wav)
    with torch.no_grad():
        cached = stack.stacked()
        stack._stacked_key = None
        fresh = stack.stacked()
    assert not torch.equal(old[0], fresh[0])
    for c, f in zip(cached, fresh):
        assert torch.equal(c, f)


def test_stacked_cache_follows_an_optimizer_step():
    _cache_after_update(torch.device("cpu"))


@pytest.mark.gpu
def test_stacked_cache_follows_an_optimizer_step_on_card(cuda):
    _cache_after_update(cuda)


@pytest.mark.gpu
def test_teacher_training_runs_the_kernels_on_card(cuda):
    """teacher_lj at full width on short crops: two steps and the eval
    run kernel 2 three times (kernel 5 once per layer each) and kernel 3
    twice."""
    cfg = override(override(get_config("teacher_lj"), "train.crop_samples",
                            2048), "train.global_batch_size", 2)
    gated_layer.launches = 0
    fs.flow_stack_train_backward.launches = 0
    res = run_teacher_training(cfg, num_steps=2)
    assert (gated_layer.launches, fs.flow_stack_train_backward.launches) == (
        3 * cfg.teacher.n_layers, 2)
    assert all(np.isfinite(v) for v in res.final_metrics.values())
