"""The port's distillation and direct student training against the JAX
reference, on the CPU at tiny sizes: the continuous MoL density, the STFT
magnitude and the power loss, the objective and the KL warm-up, the
distillation losses of every objective variant with the student's
gradients, one train step of each path, the Gaussian student base, and
both loops end to end.

Inputs come from a numpy seed, parameters from JAX's initialisers through
`convert.params_from_flax`, and the base noise z from JAX's
`sample_base_noise` on the keys its steps split, so that both packages
see the same numbers.  JAX runs its XLA stacks on the CPU (`fused_layers`
"auto"); the port's student runs its "train" stacks and the teacher its
"dx" stack, whose CPU path is the plain versions of kernels 2 and 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.models.student import StudentIAF
from pwn_tpu_torch.ops import mol
from pwn_tpu_torch.training import distill, student_direct
from pwn_tpu_torch.training.common import create_train_state
from pwn_tpu_torch.training.loop import (frozen_teacher, run_distillation,
                                         run_student_direct_training)
from pwn_tpu_torch.training.teacher import prepare_batch
from pwn_tpu_torch.utils import dsp
from torch_parity import jax_config


def _tiny(**overrides):
    """tiny_teacher's DSP (40 mels, hop 128) with a 2 x 3-layer student and
    a 3-layer teacher at C=16, fp32, two 1,024-sample crops."""
    cfg = get_config("tiny_teacher")
    for k, v in {
        "student.n_flows": 2, "student.layers_per_flow": 3,
        "student.residual_channels": 16, "student.gate_channels": 32,
        "student.skip_channels": 16,
        "teacher.n_blocks": 1, "teacher.layers_per_block": 3,
        "teacher.residual_channels": 16, "teacher.gate_channels": 32,
        "teacher.skip_channels": 16, "teacher.n_mixtures": 4,
        "train.global_batch_size": 2, "train.crop_samples": 1024,
        "train.checkpoint_every": 100, **overrides,
    }.items():
        cfg = override(cfg, k, v)
    return cfg


# the four objective variants: sampled with the MoL teacher, sampled with
# the Gaussian teacher, ClariNet's closed form, and the contrastive term
# with the KL warm-up, two KL samples and a second power-loss resolution
VARIANTS = {
    "sampled_mol": {},
    "sampled_gaussian": {"teacher.output": "gaussian"},
    "closed_form": {"teacher.output": "gaussian", "student.base": "gaussian",
                    "distill.objective": "closed_form"},
    "contrastive": {"distill.contrastive_weight": 0.3,
                    "distill.kl_warmup_steps": 10,
                    "distill.n_kl_samples": 2,
                    "distill.power_loss_resolutions": ((256, 64, 256),)},
}
STEP = 3   # the step the losses are scored at: inside the warm-up


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it (measured ~60x slower
    than alone), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree):
    return convert.params_from_flax(jax.tree.map(np.asarray, tree))


def _wav(seed=1, shape=(2, 1024)):
    return np.random.default_rng(seed).uniform(-0.6, 0.6, shape).astype(
        np.float32)


def _models(cfg):
    """(jcfg, JAX student, its variables, JAX teacher, its variables, the
    port's student in "train" loaded from the same parameters, the port's
    frozen teacher)."""
    from pwn_tpu.models.student import init_student as jax_init_student
    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher

    jcfg = jax_config(cfg)
    smodel, svars = jax_init_student(jcfg, jax.random.PRNGKey(1),
                                     use_scan=False)
    tmodel, tvars = jax_init_teacher(jcfg, jax.random.PRNGKey(0),
                                     use_scan=False)
    student = StudentIAF(cfg, stack_mode="train")
    student.load_state_dict(_flat(svars))
    teacher = frozen_teacher(cfg, _flat(tvars), "cpu")
    return jcfg, smodel, svars, tmodel, tvars, student, teacher


def _jax_z(jcfg, key, shape):
    """The noise JAX's losses draw from `key`: one z per KL sample."""
    from pwn_tpu.models.student import sample_base_noise

    keys = jax.random.split(key, jcfg.distill.n_kl_samples)
    return [np.array(sample_base_noise(jcfg, keys[i], shape))
            for i in range(jcfg.distill.n_kl_samples)]


# ----------------------------------------------------------------- the ops


def test_mol_log_density_matches_jax():
    """The continuous MoL density over values in and past [-1, 1], with
    log-scales below the floor: within 1e-5 relative."""
    from pwn_tpu.ops.mol import mol_log_density as jax_density

    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, (3, 257)).astype(np.float32)
    params = rng.standard_normal((3, 257, 30)).astype(np.float32)
    params[..., 20:] *= 6.0          # log-scales from -18: some clamped at -9
    want = np.asarray(jax_density(jnp.asarray(x), jnp.asarray(params), -9.0))
    got = mol.mol_log_density(torch.from_numpy(x), torch.from_numpy(params),
                              -9.0)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("n_fft,hop,win,T", [
    (512, 128, 512, 1024), (256, 64, 200, 1000), (2048, 512, 2048, 4096)])
def test_stft_magnitude_matches_jax(n_fft, hop, win, T):
    """|STFT| with reflect padding, a Hann window shorter than n_fft and a
    length that is not a multiple of the hop: within 1e-5 relative."""
    from pwn_tpu.utils.dsp import stft_magnitude as jax_stft

    x = _wav(2, (2, T))
    want = np.asarray(jax_stft(jnp.asarray(x), n_fft, hop, win))
    got = dsp.stft_magnitude(torch.from_numpy(x), n_fft, hop, win)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("extra", [(), ((256, 64, 256), (2048, 512, 2048))])
def test_spectral_power_loss_matches_jax(extra):
    """Single- and multi-resolution power loss: within 1e-5 relative."""
    from pwn_tpu.training.distill import spectral_power_loss as jax_power

    cfg = _tiny(**{"distill.power_loss_resolutions": extra})
    a, b = _wav(3, (2, 4096)), _wav(4, (2, 4096))
    want = float(jax_power(jnp.asarray(a), jnp.asarray(b), jax_config(cfg)))
    got = float(distill.spectral_power_loss(torch.from_numpy(a),
                                            torch.from_numpy(b), cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("overrides,match", [
    ({"distill.objective": "closed_form"}, "requires"),
    ({"distill.objective": "closed_form", "teacher.output": "gaussian"},
     "requires"),
    ({"distill.objective": "exact"}, "unknown"),
])
def test_resolve_objective_errors(overrides, match):
    """The same refusals as the reference, for the same configs."""
    from pwn_tpu.training.distill import resolve_objective as jax_resolve

    cfg = _tiny(**overrides)
    with pytest.raises(ValueError, match=match):
        distill.resolve_objective(cfg)
    with pytest.raises(ValueError, match=match):
        jax_resolve(jax_config(cfg))


def test_resolve_objective_and_kl_ramp_match_jax():
    """"auto" resolves as the reference's; the KL weight ramps linearly
    over the warm-up, is constant without one, and is full at eval."""
    from pwn_tpu.training.distill import kl_weight_at as jax_weight
    from pwn_tpu.training.distill import resolve_objective as jax_resolve

    for v in VARIANTS.values():
        cfg = _tiny(**v)
        assert distill.resolve_objective(cfg) == jax_resolve(jax_config(cfg))
    for warmup in (0, 10):
        cfg = _tiny(**{"distill.kl_warmup_steps": warmup,
                       "distill.kl_weight": 0.5})
        for step in (None, 0, 3, 9, 10, 50):
            want = float(jax_weight(jax_config(cfg), step))
            assert abs(distill.kl_weight_at(cfg, step) - want) <= 1e-7
    assert distill.kl_weight_at(cfg, 4) == pytest.approx(0.25)


def test_gaussian_base_student_matches_jax():
    """`student.base="gaussian"` (ClariNet's base, refused by the port
    before): the transform and its closed-form log-density against JAX on
    the same z, fp32, 1e-5 relative."""
    cfg = _tiny(**{"student.base": "gaussian"})
    jcfg, smodel, svars, *_ = _models(cfg)
    port = StudentIAF(cfg)
    port.load_state_dict(_flat(svars))
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 1024)).astype(np.float32)
    mel = rng.uniform(0, 1, (2, 8, 40)).astype(np.float32)
    want = smodel.apply(svars, jnp.asarray(z), jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(mel))
    for name in ("wav", "log_det", "log_p_base", "mu_total"):
        assert _rel(getattr(got, name).numpy(),
                    np.asarray(getattr(want, name))) < 1e-5, name
    assert _rel(got.log_p_student.numpy(),
                np.asarray(want.log_p_student)) < 1e-5


# -------------------------------------------------------------- the losses


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_distillation_losses_match_jax(variant):
    """Each objective variant on one batch: every metric within 1e-5
    relative of the reference's, each of the student's gradients within
    1e-4 relative L2 of jax.grad's (fp32 summed in other orders through
    the flows, the teacher and the FFTs); the frozen teacher gets none."""
    from pwn_tpu.training.distill import distillation_losses as jax_losses
    from pwn_tpu.training.teacher import prepare_batch as jax_prepare

    cfg = _tiny(**VARIANTS[variant])
    jcfg, smodel, svars, tmodel, tvars, student, teacher = _models(cfg)
    x_ref, mel = (np.asarray(a) for a in jax_prepare(jnp.asarray(_wav()),
                                                     jcfg))
    key = jax.random.PRNGKey(11)

    def loss_fn(p):
        return jax_losses(smodel, tmodel, p, tvars["params"],
                          jnp.asarray(x_ref), jnp.asarray(mel), key, jcfg,
                          step=STEP)

    (_, want), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        svars["params"])
    z = [torch.from_numpy(a) for a in _jax_z(jcfg, key, x_ref.shape)]
    loss, got = distill.distillation_losses(
        student, teacher, torch.from_numpy(x_ref), torch.from_numpy(mel),
        cfg, z=z, step=STEP)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k].detach()) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k
    names, params = zip(*student.named_parameters())
    grads = torch.autograd.grad(loss, params)
    jg = _flat(jgrads)
    assert set(names) == set(jg)
    for name, g in zip(names, grads):
        assert _l2(g.numpy(), jg[name].numpy()) <= 1e-4, name
    assert not any(p.requires_grad for p in teacher.parameters())
    assert all(p.grad is None for p in teacher.parameters())


@pytest.mark.parametrize("base", ["logistic", "gaussian"])
def test_direct_losses_match_jax(base):
    """Direct training's loss on one batch with either base: metrics within
    1e-5 relative, gradients within 1e-4 relative L2 of jax.grad's."""
    from pwn_tpu.training.student_direct import (
        direct_student_losses as jax_losses)
    from pwn_tpu.training.teacher import prepare_batch as jax_prepare

    cfg = _tiny(**{"student.base": base})
    jcfg, smodel, svars, *_ = _models(cfg)
    student = StudentIAF(cfg, stack_mode="train")
    student.load_state_dict(_flat(svars))
    x_ref, mel = (np.asarray(a) for a in jax_prepare(jnp.asarray(_wav()),
                                                     jcfg))
    key = jax.random.PRNGKey(12)
    (_, want), jgrads = jax.value_and_grad(
        lambda p: jax_losses(smodel, p, jnp.asarray(x_ref), jnp.asarray(mel),
                             key, jcfg), has_aux=True)(svars["params"])
    z = [torch.from_numpy(a) for a in _jax_z(jcfg, key, x_ref.shape)]
    loss, got = student_direct.direct_student_losses(
        student, torch.from_numpy(x_ref), torch.from_numpy(mel), cfg, z=z)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k].detach()) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k
    names, params = zip(*student.named_parameters())
    jg = _flat(jgrads)
    for name, g in zip(names, torch.autograd.grad(loss, params)):
        assert _l2(g.numpy(), jg[name].numpy()) <= 1e-4, name


# --------------------------------------------------------------- the steps


def _step_pair(cfg, jstep, step_fn, jstate, state, wav):
    """One JAX step and one port step on the same wav and the same noise
    (JAX's fold_in(rng, step) split into n_kl_samples keys); returns both
    metrics."""
    jcfg = jax_config(cfg)
    key = jax.random.fold_in(jstate.rng, jstate.step)
    z = [torch.from_numpy(a) for a in
         _jax_z(jcfg, key, (wav.shape[0], wav.shape[1]))]
    jstate, jm = jstep(jstate, jnp.asarray(wav))
    state, m = step_fn(state, torch.from_numpy(wav), z=z)
    return jstate, jm, state, m


def _check_step(jstate, jm, state, m, params, before):
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    want = _flat(jstate.params)
    assert state.step == 1 and int(jstate.step) == 1
    for k, p in params:
        moved, ref = p.detach() - before[k], want[k] - before[k]
        assert float((moved - ref).norm()) <= 1e-5 * float(before[k].norm()
                                                           + 1.0), k


def test_distill_train_step_matches_jax():
    """One step of `make_distill_train_step` against the reference's jitted
    step (Adam from the same parameters, noise from the same keys):
    metrics within 1e-5 relative, each parameter within 1e-5 of the size
    of the tensor (its norm + 1) of the JAX step's."""
    from pwn_tpu.training.common import create_train_state as jax_state
    from pwn_tpu.training.distill import make_distill_train_step as jax_mk

    cfg = _tiny()
    jcfg, smodel, svars, tmodel, tvars, student, teacher = _models(cfg)
    jstate = jax_state(svars["params"], jcfg.train, rng=jax.random.PRNGKey(2))
    jstep = jax_mk(smodel, tmodel, jcfg)
    before = {k: v.detach().clone() for k, v in student.named_parameters()}
    state = create_train_state(dict(student.named_parameters()), cfg.train)
    step_fn = distill.make_distill_train_step(student, teacher, cfg)
    jstate, jm, state, m = _step_pair(
        cfg, lambda s, w: jstep(s, tvars["params"], w), step_fn, jstate,
        state, _wav())
    _check_step(jstate, jm, state, m, student.named_parameters(), before)


def test_direct_train_step_matches_jax():
    """One direct-training step, as test_distill_train_step_matches_jax."""
    from pwn_tpu.training.common import create_train_state as jax_state
    from pwn_tpu.training.student_direct import (
        make_student_direct_train_step as jax_mk)

    cfg = _tiny()
    jcfg, smodel, svars, *_ = _models(cfg)
    student = StudentIAF(cfg, stack_mode="train")
    student.load_state_dict(_flat(svars))
    jstate = jax_state(svars["params"], jcfg.train, rng=jax.random.PRNGKey(2))
    before = {k: v.detach().clone() for k, v in student.named_parameters()}
    state = create_train_state(dict(student.named_parameters()), cfg.train)
    step_fn = student_direct.make_student_direct_train_step(student, cfg)
    jstate, jm, state, m = _step_pair(cfg, jax_mk(smodel, jcfg), step_fn,
                                      jstate, state, _wav())
    _check_step(jstate, jm, state, m, student.named_parameters(), before)


# --------------------------------------------------------------- the loops


def test_run_distillation_on_cpu():
    """The distillation loop end to end on CPU tensors: two steps, finite
    metrics with the held-out `val_*` ones, the teacher's parameters
    unchanged, and the step noise drawn from the generator (no z given);
    a data_dir without wav files raises, as the reference's (the data
    dirs' and the workdir's tests: tests/test_torch_loop.py)."""
    from pwn_tpu_torch.models.teacher import init_teacher

    cfg = _tiny(**{"distill.contrastive_weight": 0.3})
    teacher = init_teacher(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params = {k: v.clone() for k, v in teacher.state_dict().items()}
    res = run_distillation(cfg, params, num_steps=2, device="cpu")
    assert res.steps_run == 2 and res.state.step == 2
    keys = {"loss", "kl", "power_loss", "student_entropy", "teacher_xent",
            "contrastive_kl", "grad_norm"}
    assert set(res.final_metrics) == keys | {
        f"val_{k}" for k in keys - {"grad_norm"}}
    assert all(np.isfinite(v) for v in res.final_metrics.values())
    torch.testing.assert_close(teacher.state_dict(), params, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="no .wav files under wavs"):
        run_distillation(cfg, params, num_steps=1, device="cpu",
                         data_dir="wavs")


def test_run_student_direct_training_on_cpu():
    """The direct-training loop end to end on CPU tensors: two steps with
    finite metrics and their `val_*`; a data_dir without wav files
    raises."""
    cfg = _tiny()
    res = run_student_direct_training(cfg, num_steps=2, device="cpu")
    assert res.steps_run == 2 and res.state.step == 2
    keys = {"loss", "ml_nll", "power_loss"}
    assert set(res.final_metrics) == keys | {"grad_norm"} | {
        f"val_{k}" for k in keys}
    assert all(np.isfinite(v) for v in res.final_metrics.values())
    with pytest.raises(FileNotFoundError, match="no .wav files under wavs"):
        run_student_direct_training(cfg, data_dir="wavs", num_steps=1,
                                    device="cpu")


def test_step_noise_is_seeded_by_seed_and_step():
    """Without z, a step's noise is a function of (state.seed, state.step):
    the same state gives the same loss twice, another step another loss."""
    cfg = _tiny()
    student = StudentIAF(cfg, stack_mode="train")
    student.reset_parameters(torch.Generator().manual_seed(3))
    x_ref, mel = prepare_batch(torch.from_numpy(_wav()), cfg)
    losses = []
    with torch.no_grad():
        for step in (5, 5, 6):
            gen = distill.step_generator(7, step, "cpu")
            losses.append(float(student_direct.direct_student_losses(
                student, x_ref, mel, cfg, generator=gen)[0]))
    assert losses[0] == losses[1] != losses[2]
