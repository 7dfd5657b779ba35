"""The JAX package's wide teacher, teacher_lj with 256 residual, 512 gate
and 256 skip channels ((C, G, S, M) = (256, 512, 256, 80), "wide
(24 x 256ch)" in BASELINE.md), and stacks with a dilation above the
reference's time tile (TIME_TILE = 512), against the JAX reference on the
CPU; and, on a CUDA card only, the kernels that run them against their
plain versions.

On the CPU (2 blocks x 3 layers at the full widths, inputs from a numpy
seed, parameters from JAX's initialisers through `convert.params_from_flax`):
the teacher's loss and every gradient through the port's "train" stack
(the plain versions of kernels 2 and 3) in fp32 and bf16; the whole-loop
AR sampler's plain version against JAX's `fast_sample` on one noise
stream; the distillation losses and the student's gradients with the wide
teacher frozen ("dx", kernel 3's dx-only plain version); a stack with
dilations (1, 1024, 2048) in every mode, which builds "layer" as the
reference falls back to its XLA per-layer form; and the routes that send
these widths to the kernels (`kernel_body`: bf16 to the wgmma bodies'
column-split instantiation, fp32 to the general bodies within
`generic_limits`; `AR_KERNEL_DIMS` and `ar_body`).

The CUDA cases are marked `gpu` and skip without a card; JAX is imported
inside the tests that need it:

    python -m pytest --noconftest -m gpu tests/test_torch_wide.py
"""

import numpy as np
import pytest
import torch

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.models.modules import (STACK_MODES, WaveNetStack,
                                          resolve_stack_mode)
from pwn_tpu_torch.models.student import StudentIAF
from pwn_tpu_torch.models.teacher import TeacherWaveNet
from pwn_tpu_torch.ops import flow_stack as fs
from pwn_tpu_torch.ops.ar_sampler import (AR_KERNEL_DIMS, ar_body,
                                          ar_geometry, ar_sample,
                                          ar_sample_reference, check_ar_args,
                                          stack_teacher_weights)
from pwn_tpu_torch.ops.gated_layer import TIME_TILE, gated_layer, \
    gated_layer_reference
from test_torch_generic import GRADS, TOL, TOL_ACTS, _row_rel, _stack_ops
from torch_parity import jax_config

WIDE = (256, 512, 256, 80)
F32, BF16 = torch.float32, torch.bfloat16
PIN = 25.0   # on component 0's logit bias: tests/test_torch_sampling.py
FAR = (1, 1024, 2048)   # dilations past the reference's time tile


def wide_config(n_blocks: int = 2, layers: int = 3,
                dtype: str = "float32", **overrides):
    """teacher_lj with the wide teacher's channels (the JAX package's
    `teacher.residual_channels=256 teacher.gate_channels=512
    teacher.skip_channels=256`), cut to `n_blocks` x `layers` layers."""
    cfg = get_config("teacher_lj")
    for k, v in {"teacher.residual_channels": 256,
                 "teacher.gate_channels": 512,
                 "teacher.skip_channels": 256,
                 "teacher.n_blocks": n_blocks,
                 "teacher.layers_per_block": layers,
                 "teacher.compute_dtype": dtype, **overrides}.items():
        cfg = override(cfg, k, v)
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    import jax

    return convert.params_from_flax(jax.tree.map(np.asarray, tree))


def _wav(seed=1, shape=(1, 1024)):
    return np.random.default_rng(seed).uniform(-0.6, 0.6, shape).astype(
        np.float32)


def _rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------- the routes


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("backward", [False, True])
def test_wide_widths_route_by_dtype(dtype, backward):
    """Kernels 5 (and so 2) and 3 run the wide widths in bf16 on their
    wgmma bodies (the column-split instantiation), and in fp32, which
    wgmma does not take, on their general bodies: 64-row tiles forward
    (106,496 bytes a block), 32-row tiles backward (131,584: a 64-row
    block's dout / dg and dz tiles would take 238,592)."""
    if dtype == BF16:
        assert WIDE in fs.TRAIN_KERNEL_DIMS
        assert fs.kernel_body(dtype, *WIDE, backward=backward) == "wgmma"
        return
    assert fs.kernel_body(dtype, *WIDE, backward=backward) == "generic"
    assert fs.generic_limits(dtype, *WIDE, backward=backward) is None
    assert fs.generic_tile_rows(*WIDE, backward=backward) == (
        32 if backward else 64)
    assert fs.generic_smem_bytes(*WIDE, backward=backward) == (
        131_584 if backward else 106_496)
    assert fs._generic_smem_at(64, *WIDE, True) == 238_592


@pytest.mark.parametrize("dims,backward,smem", [
    ((64, 128, 64, 80), False, 132_160), ((64, 128, 64, 80), True, 164_976),
    ((128, 256, 128, 80), False, 230_464),
    ((128, 256, 128, 80), True, 230_512),
    (WIDE, False, 214_104), (WIDE, True, 214_112),
])
def test_wgmma_bodies_fit_a_block(dims, backward, smem):
    """The wgmma bodies' shared memory (`wgmma_smem_bytes`, the mirror of
    the CUDA sources' layouts) at each width they are built for fits a
    Hopper block: the wide widths' 64-row tiles with column-split weight
    stages (kernel 5: x, tap, cond and z 112 KB, three 32 KB stages;
    kernel 3: [x | tap | cond] 80 KB, dout / dg 64 KB, four 16 KB slots)
    take less than teacher_lj's 128-row tiles."""
    assert fs.wgmma_smem_bytes(*dims, backward=backward) == smem
    assert smem <= fs.SMEM_PER_BLOCK


def test_wgmma_smem_refuses_unbuilt_widths():
    """There is no wgmma body, so no layout, at a width outside
    TRAIN_KERNEL_DIMS."""
    with pytest.raises(ValueError, match="no wgmma body"):
        fs.wgmma_smem_bytes(64, 128, 64, 40)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wide_stack_packs_only_for_the_general_bodies(dtype):
    """The column split needs no weight layout of its own: the wgmma
    bodies read `stacked()`'s (out, in) weights by TMA boxes at the split's
    coordinates, so a bf16 wide stack packs nothing for the general body
    (`_generic_for` is None on a card tensor) and an fp32 one packs the
    general layout, which unpacks to `stacked()`'s weights bit for bit."""
    port = WaveNetStack((1, 2), *WIDE[:3], 2, WIDE[3], dtype=dtype,
                        mode="train")
    port.reset_parameters(torch.Generator().manual_seed(9))
    want = "wgmma" if dtype == BF16 else "generic"
    assert fs.kernel_body(dtype, *port.widths, backward=True) == want
    with torch.no_grad():
        w_in, _, w_out, _ = port.stacked()
        p = port.generic_weights()
    GH = WIDE[1] // 2
    gate = p.gate.transpose(-1, -2).reshape(2, -1, p.gate.shape[-2])
    tanh = gate.reshape(2, -1, 2, 64, gate.shape[-1])[:, :, 0]
    assert torch.equal(tanh.reshape(2, -1, gate.shape[-1])[:, :GH,
                                                          :w_in.shape[-1]],
                       w_in[:, :GH].float())
    out = p.out.transpose(1, 2).reshape(2, p.out.shape[2], -1)
    assert torch.equal(out[:, :GH, :w_out.shape[1]], w_out.mT.float())


def test_ar_kernel_takes_the_wide_widths():
    """The AR kernel is built at the wide widths: its argument check
    passes them and stops only at the device (CPU tensors here).  Widths
    next to them that no built body takes, (128, 512, 128, 80), route to
    the general body; only past `generic_ar_limits` is a width refused."""
    assert WIDE in AR_KERNEL_DIMS
    cfg = wide_config(1, 2)
    port = TeacherWaveNet(cfg)
    weights = stack_teacher_weights(port.stack, BF16)
    tc = cfg.teacher
    assert ar_body(*WIDE, tc.n_layers, tc.n_mixtures) == "chunks"
    cond = torch.zeros(1, 4, 80, dtype=BF16)
    noise = torch.full((4, 1, tc.n_mixtures + 1), 0.5)
    with pytest.raises(ValueError, match="CUDA device"):
        check_ar_args(cond, noise, weights, tc.dilations, tc.n_mixtures,
                      "mol")
    assert ar_body(128, 512, 128, 80, tc.n_layers, tc.n_mixtures) == \
        "generic"
    with pytest.raises(ValueError, match="general AR body"):
        ar_body(256, 800_000, 256, 80, tc.n_layers, tc.n_mixtures)


@pytest.mark.parametrize("flag", ["auto", "mega", "mega_train", "mega_dx",
                                  "on", "layer", "off"])
def test_dilations_past_the_tile_build_layer(flag):
    """A stack with a dilation above TIME_TILE resolves to "layer" whatever
    the flag and context ask for, as the reference's stack takes its XLA
    per-layer form where `tile_ok` is false, and refuses another mode built
    directly: 11 layers a block or a flow (dilations to 1,024); 10 keep the
    flag's mode.  Kernel 1 declines such a stack; the reference's per-layer
    API still refuses the dilation."""
    for context in ("infer", "train"):
        mode = resolve_stack_mode(flag, context)
        assert resolve_stack_mode(flag, context, FAR) == "layer"
        assert resolve_stack_mode(flag, context, (1, 512)) == mode
        assert WaveNetStack((1, 512), 16, 32, 16, 2, 8,
                            mode=mode).mode == mode
        if mode != "layer":
            with pytest.raises(ValueError, match="resolve_stack_mode"):
                WaveNetStack(FAR, 16, 32, 16, 2, 8, mode=mode)
    teacher = override(get_config("teacher_lj"), "teacher.fused_layers",
                       flag)
    assert max(teacher.teacher.dilations) == 128
    far = override(teacher, "teacher.layers_per_block", 11)
    assert max(far.teacher.dilations) == 1024
    assert TeacherWaveNet(far, stack_mode="train").stack.mode == "layer"
    assert TeacherWaveNet(far).stack.mode == "layer"
    student = override(override(get_config("student_iaf"),
                                "student.fused_layers", flag),
                       "student.layers_per_flow", 11)
    assert {f.mode for f in StudentIAF(student).flows} == {"layer"}
    assert not fs.kernel1_takes((1, 1024), 64, 128, 64, 80)
    from pwn_tpu_torch.ops.gated_layer import fused_gated_residual

    x = torch.zeros(1, 8, 4)
    p = WaveNetStack((1,), 4, 8, 4, 2, 2).layer_0
    with pytest.raises(ValueError, match="TIME_TILE"):
        fused_gated_residual(x, torch.zeros(1, 8, 2), p.w_dilated,
                             p.b_dilated, p.w_cond, p.b_cond, p.w_res,
                             p.b_res, p.w_skip, p.b_skip,
                             dilation=TIME_TILE + 1)


# ------------------------------------------------- against the reference


# bf16: the loss within 1e-4 relative (1.8e-6 measured) and each gradient
# within 0.15 of its norm (0.085 measured, fp32 1.6e-3).  The port's
# "train" stack keeps the whole-stack kernels' rounding (b_g and b_rs
# rounded to bf16, the skip summed in fp32) where the JAX package's CPU
# path runs its XLA per-layer form (the skip summed in bf16, the gate
# pre-activation rounded to bf16): the divergence ROADMAP.md's queue 3
# records for "off", which six bf16 layers, the bf16 heads and the MoL
# likelihood's gradient (it cancels to ~1e-5 of its terms) carry to
# several per cent of a gradient.
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
GRAD_TOL = {"float32": 2e-3, "bfloat16": 0.15}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_teacher_loss_and_gradients_match_jax(dtype):
    """The wide teacher (2 x 3 layers, one 1,024-sample crop: the mel's
    reflect padding needs more than n_fft / 2) in the training loop's
    "train" stack, whose CPU path is the plain versions of kernels 2 and 3,
    against jax.grad of the JAX package's loss on the same converted
    weights: fp32 the loss within 1e-5 relative and each gradient within
    2e-3 of its norm (tests/test_torch_training.py's gate; the MoL
    gradient's cancellation leaves that much fp32 noise); bf16 as
    LOSS_TOL / GRAD_TOL state."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher
    from pwn_tpu.training.teacher import prepare_batch as jax_prepare

    from pwn_tpu_torch.training.teacher import prepare_batch

    cfg = wide_config(dtype=dtype)
    jcfg = jax_config(cfg)
    model, variables = jax_init_teacher(jcfg, jax.random.PRNGKey(2),
                                        use_scan=False)
    port = TeacherWaveNet(cfg, stack_mode="train")
    assert port.stack.mode == "train" and port.stack.widths == WIDE
    port.load_state_dict(_flat(variables))
    wav = _wav()
    x, mel = jax_prepare(jnp.asarray(wav), jcfg)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: model.apply(
        {"params": p}, x, mel, method="loss")))(variables["params"])
    want = _flat(want)
    loss = port.loss(*prepare_batch(torch.from_numpy(wav), cfg))
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        LOSS_TOL[dtype] * abs(float(want_loss))
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        assert float((g - want[n]).norm()) <= \
            GRAD_TOL[dtype] * float(want[n].norm()), n


@pytest.mark.parametrize("head", ["mol", "gaussian"])
def test_wide_fast_sample_kernel_matches_jax(head):
    """`fast_sample_kernel` (the whole-loop sampler; its plain version on
    the CPU, which the kernel is held to on the card) on the wide teacher
    (2 x 3 layers, fp32, B = 2, two frames = 512 steps) against JAX's
    `fast_sample(uniforms=...)` on the same stream: 1e-4 absolute, the
    tolerance between two fp32 backends of tests/test_torch_sampling.py;
    the MoL head pinned (+25 on component 0's logit bias) so that no
    Gumbel-max choice flips."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models import sampling as jax_sampling
    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher

    from pwn_tpu_torch.models import sampling

    cfg = wide_config(**({"teacher.output": "gaussian",
                          "student.base": "gaussian"}
                         if head == "gaussian" else {}))
    model, variables = jax_init_teacher(jax_config(cfg),
                                        jax.random.PRNGKey(3))
    variables = jax.tree.map(np.array, variables)
    if head == "mol":
        variables["params"]["stack"]["head2"]["bias"][0] += PIN
    port = TeacherWaveNet(cfg)
    port.load_state_dict(_flat(variables))
    rng = np.random.default_rng(6)
    hop = cfg.dsp.hop_length
    mel = rng.uniform(0, 1, (2, 2, cfg.dsp.n_mels)).astype(np.float32)
    nz = 1 if head == "gaussian" else cfg.teacher.n_mixtures + 1
    noise = (rng.standard_normal((2 * hop, 2, 1)) if head == "gaussian"
             else rng.uniform(1e-5, 1 - 1e-5, (2 * hop, 2, nz)))
    noise = noise.astype(np.float32)
    want = np.asarray(jax_sampling.fast_sample(
        model, variables, jax.random.PRNGKey(0), jnp.asarray(mel),
        uniforms=jnp.asarray(noise)))
    got = sampling.fast_sample_kernel(port, None, torch.from_numpy(mel),
                                      noise=torch.from_numpy(noise))
    assert got.shape == (2, 2 * hop)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert (np.abs(want) < 1.0).mean() > 0.2   # not all on the clip


def test_wide_teacher_distillation_losses_match_jax():
    """A 2 x 3-layer student (C = 16) distilled from the wide teacher
    frozen in "dx" (kernel 3's dx-only plain version on the CPU), teacher_lj's
    DSP, fp32, one batch of two 1,024-sample crops: every metric within
    1e-5 relative of the JAX package's `distillation_losses`, each of the
    student's gradients within 1e-4 relative L2 of jax.grad's (the gates
    of tests/test_torch_distill.py); the teacher gets no gradient."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.student import init_student as jax_init_student
    from pwn_tpu.models.student import sample_base_noise
    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher
    from pwn_tpu.training.distill import distillation_losses as jax_losses
    from pwn_tpu.training.teacher import prepare_batch as jax_prepare

    from pwn_tpu_torch.training import distill
    from pwn_tpu_torch.training.loop import frozen_teacher

    cfg = wide_config()
    for k, v in {"student.n_flows": 2, "student.layers_per_flow": 3,
                 "student.residual_channels": 16, "student.gate_channels": 32,
                 "student.skip_channels": 16,
                 "student.compute_dtype": "float32",
                 "train.global_batch_size": 2,
                 "train.crop_samples": 1024}.items():
        cfg = override(cfg, k, v)
    jcfg = jax_config(cfg)
    smodel, svars = jax_init_student(jcfg, jax.random.PRNGKey(1),
                                     use_scan=False)
    tmodel, tvars = jax_init_teacher(jcfg, jax.random.PRNGKey(0),
                                     use_scan=False)
    student = StudentIAF(cfg, stack_mode="train")
    student.load_state_dict(_flat(svars))
    teacher = frozen_teacher(cfg, _flat(tvars), "cpu")
    assert teacher.stack.mode == "dx" and teacher.stack.widths == WIDE
    x_ref, mel = (np.asarray(a) for a in jax_prepare(
        jnp.asarray(_wav(shape=(2, 1024))), jcfg))
    key = jax.random.PRNGKey(11)

    def loss_fn(p):
        return jax_losses(smodel, tmodel, p, tvars["params"],
                          jnp.asarray(x_ref), jnp.asarray(mel), key, jcfg,
                          step=3)

    (_, want), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        svars["params"])
    keys = jax.random.split(key, jcfg.distill.n_kl_samples)
    z = [torch.from_numpy(np.array(sample_base_noise(jcfg, k, x_ref.shape)))
         for k in keys]
    loss, got = distill.distillation_losses(
        student, teacher, torch.from_numpy(x_ref), torch.from_numpy(mel),
        cfg, z=z, step=3)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k].detach()) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k
    names, params = zip(*student.named_parameters())
    grads = torch.autograd.grad(loss, params)
    jg = _flat(jgrads)
    assert set(names) == set(jg)
    for name, g in zip(names, grads):
        assert _rel_norm(g.numpy(), jg[name].numpy()) <= 1e-4, name
    assert all(p.grad is None for p in teacher.parameters())


def _far_pair(dtype, mode, seed=0):
    """A port stack with dilations FAR (C = 16, G = 32, S = 16, M = 8)
    asked for in `mode`, every parameter jittered (a fresh init has zero
    biases), and the JAX package's stack on the same parameters, which
    takes its XLA per-layer form there (`tile_ok` false)."""
    import jax.numpy as jnp

    from pwn_tpu.models.modules import WaveNetStack as JaxStack

    port = WaveNetStack(FAR, 16, 32, 16, 2, 8, dtype=dtype,
                        mode=resolve_stack_mode(mode, "train", FAR))
    gen = torch.Generator().manual_seed(seed)
    port.reset_parameters(gen)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    jstack = JaxStack(dilations=FAR, residual_channels=16, gate_channels=32,
                      skip_channels=16, out_dim=2,
                      dtype=jnp.float32 if dtype == F32 else jnp.bfloat16,
                      mega=mode == "infer", mega_train=mode == "train",
                      mega_dx=mode == "dx", fused=mode == "layer",
                      use_scan=False)
    return port, jstack, convert.params_to_flax(port.state_dict())


@pytest.mark.parametrize("mode", sorted(STACK_MODES))
def test_far_dilations_match_jax_in_every_mode(mode):
    """A stack with dilations (1, 1024, 2048) at T = 2,600 (the taps of the
    last two layers reach past a third and past the start), asked for in
    each mode, builds "layer" and matches the JAX stack asked for the same
    (its XLA fallback) at fp32: a weighted loss of the outputs within 1e-5
    relative, its gradient in x, cond and every parameter within 2e-3 of
    its norm (the gate of test_unported_variants_raise,
    tests/test_torch_teacher.py)."""
    import jax
    import jax.numpy as jnp

    port, jstack, params = _far_pair(F32, mode)
    assert port.mode == "layer"
    rng = np.random.default_rng(12)
    x = rng.uniform(-0.8, 0.8, (1, 2600, 1)).astype(np.float32)
    cond = rng.uniform(0, 1, (1, 2600, 8)).astype(np.float32)
    w = rng.standard_normal((1, 2600, 2)).astype(np.float32)

    def jloss(p, x, cond):
        return jnp.sum(jstack.apply({"params": p}, x, cond) * w)

    want_loss, want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        params, jnp.asarray(x), jnp.asarray(cond))
    want_p = convert.params_from_flax(jax.tree.map(np.asarray, want[0]))
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(cond).requires_grad_(True)
    loss = (port(xt, ct) * torch.from_numpy(w)).sum()
    names, ps = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, [xt, ct, *ps])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for n, g, ref in zip(("x", "cond", *names), grads,
                         [want[1], want[2], *(want_p[n] for n in names)]):
        ref = np.asarray(ref)
        assert float(np.linalg.norm(g.numpy() - ref)) <= \
            2e-3 * float(np.linalg.norm(ref)), n


# The wide teacher's stack mode is not the reference's, deliberately: the
# reference takes its whole-stack kernels only where `mega_fits_vmem` holds
# (a 12 MB VMEM budget, a TPU fact the port does not carry), which fails at
# these widths (28.4 MB at 24 layers in bf16), so on the TPU it runs the
# per-layer form (`fused_gated_residual` a layer, the skip summed in the
# compute dtype).  The port keeps "infer" there (the skip summed in fp32).
# bf16: max|diff| within 0.02 of max|want| (0.0068, 0.0070 and 0.0080 over
# three seeds at 3 layers, B=1, T=128: the per-layer form's bf16 skip sum
# and its rounded layer outputs); fp32: the summation order alone, 1e-4.
F6_TOL = {"float32": 1e-4, "bfloat16": 0.02}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_stack_keeps_its_mode_against_the_per_layer_form(dtype):
    """F6: the wide teacher resolves to "infer" (and "train" in the
    training loop) where the reference, past `mega_fits_vmem` at 24
    layers, runs per layer.  Its forward (fp32 skip sum) against the JAX
    stack with fused=True (the Pallas per-layer kernel, interpret mode) at
    3 layers, B=1, T=128: fp32 to fp32 rounding, bf16 at the stated gap
    (F6_TOL)."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.modules import WaveNetStack as JaxStack
    from pwn_tpu.ops.pallas.flow_stack import mega_fits_vmem

    full = wide_config(3, 8, "bfloat16")
    assert full.teacher.n_layers == 24
    assert not mega_fits_vmem(24, *WIDE, 2)
    assert TeacherWaveNet(full).stack.mode == "infer"
    assert TeacherWaveNet(full, stack_mode=resolve_stack_mode(
        full.teacher.fused_layers, "train")).stack.mode == "train"
    dil = (1, 2, 4)
    C, G, S, M = WIDE
    dt = {"float32": F32, "bfloat16": BF16}[dtype]
    port = WaveNetStack(dil, C, G, S, 30, M, dtype=dt)
    assert port.mode == "infer"
    gen = torch.Generator().manual_seed(0)
    port.reset_parameters(gen)
    with torch.no_grad():
        for p in port.parameters():  # a fresh init has zero biases
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    jstack = JaxStack(dilations=dil, residual_channels=C, gate_channels=G,
                      skip_channels=S, out_dim=30, dtype=jnp.dtype(dtype),
                      fused=True)
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.8, 0.8, (1, 128, 1)).astype(np.float32)
    cond = rng.uniform(0, 1, (1, 128, M)).astype(np.float32)
    want = np.asarray(jax.jit(jstack.apply)(
        {"params": convert.params_to_flax(port.state_dict())},
        jnp.asarray(x), jnp.asarray(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    tol = F6_TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        gap = np.abs(got - want).max() / np.abs(want).max()
        assert 0 < gap <= tol, gap


def test_far_dilations_match_jax_in_bf16():
    """The same stack in bf16 ("layer", kernel 5's per-layer rounding)
    against the JAX package's bf16 XLA form: the outputs within 0.05 of
    their largest magnitude (0.019 measured).  The two differ by the
    rounding ROADMAP.md's queue 3 records for "off": XLA rounds the summed
    gate bias, the residual and skip biases and the gate pre-activation to
    bf16, kernel 5 keeps them in fp32, and three layers and the bf16 heads
    carry it."""
    import jax
    import jax.numpy as jnp

    port, jstack, params = _far_pair(BF16, "layer", seed=1)
    rng = np.random.default_rng(13)
    x = rng.uniform(-0.8, 0.8, (1, 2600, 1)).astype(np.float32)
    cond = rng.uniform(0, 1, (1, 2600, 8)).astype(np.float32)
    want = np.asarray(jax.jit(jstack.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


# ------------------------------------------------------------- CUDA only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda()   # TF32 off: the plain versions are true fp32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wide_general_bodies_match_plain_on_card(cuda, dtype):
    """Kernel 2's route (kernel 5's accumulate epilogue) and kernel 3 at
    the wide widths, 3 layers at B x T = 2 x 257, on the body `kernel_body`
    picks for the dtype (fp32: the general bodies; bf16: the wgmma bodies'
    column split), against their plain versions on the same card operands
    per row: the skip and the saved inputs, and kernel 3 in both modes (dx
    per row, dcond and each weight gradient per tensor); dx and dcond the
    same bits in both modes."""
    from pwn_tpu_torch.ops.gated_layer import gated_layer as k5

    dil = (1, 2, 300)
    body = fs.kernel_body(dtype, *WIDE)
    key3 = (lambda w: ("generic", 256, w)) if body == "generic" else (
        lambda w: (256, w))
    a = _stack_ops(WIDE, dtype, dil, B=2, T=257, device=cuda)
    dskip = a.pop("dskip")
    by = k5.launches_by.copy()
    skip, acts = fs.flow_stack_train_forward(**a, dilations=dil)
    assert k5.launches_by[(body, "accumulate")] == \
        by[(body, "accumulate")] + len(dil)
    ref_skip, ref_acts = fs.flow_stack_train_reference(**a, dilations=dil)
    assert (_row_rel(skip, ref_skip) <= TOL[dtype]).all()
    assert (_row_rel(acts.transpose(0, 1), ref_acts.transpose(0, 1))
            <= TOL_ACTS[dtype]).all()
    bargs = (acts, a["cond"], a["w_in"], a["b_g"], a["w_out"], dskip)
    runs = {}
    for want_w in (True, False):
        n = fs.flow_stack_train_backward.launches_by[key3(want_w)]
        got = fs.flow_stack_train_backward(*bargs, dilations=dil,
                                           want_wgrads=want_w)
        assert fs.flow_stack_train_backward.launches_by[
            key3(want_w)] == n + 1
        ref = fs.flow_stack_backward_reference(*bargs, dilations=dil,
                                               want_wgrads=want_w)
        assert (_row_rel(got[0], ref[0]) <= TOL[dtype]).all()
        for name, g, r in zip(GRADS, got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape, name
            assert float(_row_rel(g[None], r[None])[0]) <= TOL[dtype], name
        runs[want_w] = got
    assert torch.equal(runs[True][0], runs[False][0])
    assert torch.equal(runs[True][1], runs[False][1])


WGMMA_DIL = (1, 2, 300, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(2, 700), (1, 1), (3, 63), (3, 6000)])
def test_wide_wgmma_bodies_match_plain_on_card(cuda, B, T):
    """The wgmma bodies' column split at the wide widths in bf16, dilations
    (1, 2, 300, 512), against the plain versions in fp32 on the same bf16
    operands per row (0.02, as at teacher_lj's widths), at shapes whose
    persistent blocks take one tile each and (3 x 6,000: 282 tiles of 64
    rows) several: kernel 5's "layer"
    epilogue at each dilation (res and skip), its accumulate epilogue as
    kernel 2's route (the skip, and the saved inputs against the bf16
    plain version within 0.04), kernel 3 with and without weight gradients
    (dx per row, dcond and each weight gradient per tensor); dx and dcond
    the same bits in both modes and in a second run; the launches on
    ("wgmma", ...) and kernel 3's (256, want_wgrads)."""
    from pwn_tpu_torch.ops.gated_layer import gated_layer as k5

    dil = WGMMA_DIL
    a = _stack_ops(WIDE, BF16, dil, B=B, T=T, seed=T + 17, device=cuda)
    a32 = {k: v.float() for k, v in a.items()}
    dskip = a.pop("dskip")
    by = k5.launches_by.copy()
    with torch.inference_mode():
        for l, d in enumerate(dil):
            top = [a[k][l] for k in ("w_in", "b_g", "w_out", "b_rs")]
            got = gated_layer(a["x0"], a["cond"], *top, d)
            want = gated_layer_reference(
                a32["x0"], a32["cond"], *(t.float() for t in top), d)
            for g, w in zip(got, want):
                assert (_row_rel(g, w) <= TOL[BF16]).all(), (d, l)
    assert k5.launches_by[("wgmma", "layer")] == \
        by[("wgmma", "layer")] + len(dil)
    skip, acts = fs.flow_stack_train_forward(**a, dilations=dil)
    assert k5.launches_by[("wgmma", "accumulate")] == \
        by[("wgmma", "accumulate")] + len(dil)
    ref_skip, _ = fs.flow_stack_train_reference(
        **{k: v for k, v in a32.items() if k != "dskip"}, dilations=dil)
    _, ref_acts = fs.flow_stack_train_reference(**a, dilations=dil)
    assert (_row_rel(skip, ref_skip) <= TOL[BF16]).all()
    assert (_row_rel(acts.transpose(0, 1), ref_acts.transpose(0, 1))
            <= TOL_ACTS[BF16]).all()
    bargs = (acts, a["cond"], a["w_in"], a["b_g"], a["w_out"], dskip)
    runs = {}
    for want_w in (True, False):
        n = fs.flow_stack_train_backward.launches_by[(256, want_w)]
        got = fs.flow_stack_train_backward(*bargs, dilations=dil,
                                           want_wgrads=want_w)
        assert fs.flow_stack_train_backward.launches_by[(256, want_w)] \
            == n + 1
        ref = fs.flow_stack_backward_reference(
            *(t.float() for t in bargs), dilations=dil, want_wgrads=want_w)
        assert (_row_rel(got[0], ref[0]) <= TOL[BF16]).all()
        for name, g, r in zip(GRADS, got, ref):
            assert g.shape == r.shape, name
            assert float(_row_rel(g[None], r[None])[0]) <= TOL[BF16], name
        runs[want_w] = got
    again = fs.flow_stack_train_backward(*bargs, dilations=dil)
    assert all(torch.equal(x, y) for x, y in zip(runs[True], again))
    assert torch.equal(runs[True][0], runs[False][0])
    assert torch.equal(runs[True][1], runs[False][1])


def _wide_weights(cfg, head, dtype, device, front: float = 1.0):
    """The wide teacher's packed AR weights: the init's, every bias
    jittered (an init has zero biases, which would hide a bias read from the
    wrong column), the MoL head pinned.  Jittering the weights too makes
    the Gaussian loop chaotic at these widths: a 1e-7 relative change of
    W_in moves its 64th sample by 8e-4 in the plain version alone, 1e-5
    with only the biases jittered."""
    port = TeacherWaveNet(cfg)
    gen = torch.Generator().manual_seed(5)
    port.reset_parameters(gen)
    with torch.no_grad():
        port.stack.front.kernel.mul_(front)
        for p in port.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        if head == "mol":
            port.stack.head2.bias[0] += PIN
    return stack_teacher_weights(port.to(device).stack, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["mol", "gaussian"])
@pytest.mark.parametrize("wdtype", [BF16, F32])
def test_wide_ar_kernel_matches_plain_on_card(cuda, head, wdtype):
    """Kernel 4 at the wide widths (all 24 layers, dilations 1..128 x 3),
    bf16 and fp32 weights, against its plain version on the same card
    operands, B = 2, T = 64 steps: within 1e-3 absolute (chip_smoke.py's
    gate over 64 steps: fp32 sums in another order, fed back)."""
    extra = ({"teacher.output": "gaussian", "student.base": "gaussian"}
             if head == "gaussian" else {})
    cfg = wide_config(3, 8, **extra)
    tc = cfg.teacher
    w = _wide_weights(cfg, head, wdtype, cuda)
    gen = torch.Generator().manual_seed(7)
    B, T = 2, 64
    cond = (torch.randn(B, T, 80, generator=gen) * 0.5).to(BF16).to(cuda)
    nz = 1 if head == "gaussian" else tc.n_mixtures + 1
    noise = (torch.randn(T, B, 1, generator=gen) if head == "gaussian"
             else torch.rand(T, B, nz, generator=gen) * 0.998 + 0.001)
    noise = noise.to(cuda)
    kw = dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures, head=head,
              log_scale_min=tc.log_scale_min)
    n = ar_sample.launches
    got = ar_sample(cond, noise, w, **kw)
    assert ar_sample.launches == n + 1
    want = ar_sample_reference(cond, noise, w, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-3
    assert (got.abs() < 1.0).float().mean() > 0.2


def _wide_ar_inputs(cfg, head, B, T, seed, device):
    """bf16 cond and the head's noise, (B, T), from a torch seed."""
    gen = torch.Generator().manual_seed(seed)
    cond = (torch.randn(B, T, 80, generator=gen) * 0.5).to(BF16).to(device)
    nz = 1 if head == "gaussian" else cfg.teacher.n_mixtures + 1
    noise = (torch.randn(T, B, 1, generator=gen) if head == "gaussian"
             else torch.rand(T, B, nz, generator=gen) * 0.998 + 0.001)
    return cond, noise.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["mol", "gaussian"])
@pytest.mark.parametrize("wdtype", [BF16, F32])
@pytest.mark.parametrize("B", [1, 3])
def test_wide_ar_kernel_takes_batches_rows_do_not_divide_on_card(
        cuda, head, wdtype, B):
    """The wide kernel runs R = 2 rows a cluster: B = 1 and B = 3 (a
    cluster with one row past the batch) against the plain version over 64
    steps within 1e-3, as B = 2 above."""
    extra = ({"teacher.output": "gaussian", "student.base": "gaussian"}
             if head == "gaussian" else {})
    cfg = wide_config(3, 8, **extra)
    tc = cfg.teacher
    w = _wide_weights(cfg, head, wdtype, cuda)
    cond, noise = _wide_ar_inputs(cfg, head, B, 64, 9 + B, cuda)
    kw = dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures, head=head,
              log_scale_min=tc.log_scale_min)
    geo = ar_geometry(w, n_mixtures=tc.n_mixtures, head=head,
                      cond_dtype=cond.dtype)
    assert geo["rows"] == 2  # B = 3: the second cluster's row 1 is past B
    got = ar_sample(cond, noise, w, **kw)
    want = ar_sample_reference(cond, noise, w, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, 64)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_wide_ar_rows_of_a_cluster_are_independent_on_card(cuda):
    """Rows 0 and 1 share a cluster (and every weight read): changing row
    1's cond leaves row 0 the same bits."""
    cfg = wide_config(3, 8)
    tc = cfg.teacher
    w = _wide_weights(cfg, "mol", BF16, cuda)
    cond, noise = _wide_ar_inputs(cfg, "mol", 2, 64, 12, cuda)
    kw = dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures, head="mol",
              log_scale_min=tc.log_scale_min)
    a = ar_sample(cond, noise, w, **kw)
    cond = cond.clone()
    cond[1] += 1.0
    b = ar_sample(cond, noise, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [BF16, F32])
def test_wide_ar_geometry_on_card(cuda, wdtype):
    """The wide kernel's launch: 2 rows x 16 blocks a cluster, a ring of at
    least 2 stages within a block's shared memory, and room on the card for
    the 4 clusters of a batch of 8 at once."""
    cfg = wide_config(3, 8)
    w = _wide_weights(cfg, "mol", wdtype, cuda)
    geo = ar_geometry(w, n_mixtures=cfg.teacher.n_mixtures, head="mol",
                      cond_dtype=BF16)
    assert (geo["rows"], geo["ranks"]) == (2, 16)
    assert geo["stages"] >= 2 and geo["smem"] <= 232448
    assert geo["clusters"] >= 4


@pytest.mark.gpu
def test_ar_kernel_takes_dilations_past_the_tile_on_card(cuda):
    """Kernel 4 keeps its queues in device memory, so a dilation above the
    reference's time tile needs nothing of it: teacher_lj's widths with 11
    layers a block (dilations to 1,024), bf16 weights, against the plain
    version over 1,100 steps (the d = 1,024 taps leave the padding at step
    1,024): 1e-3 over the first 64 steps and 0.05 over all, chip_smoke.py's
    gates; the front 1x1 scaled by 0.3 keeps the random-init loop from
    amplifying rounding (chip_smoke.py's WIDE_AR_FRONT)."""
    cfg = override(get_config("teacher_lj"), "teacher.layers_per_block", 11)
    tc = cfg.teacher
    assert max(tc.dilations) == 1024
    w = _wide_weights(cfg, "mol", BF16, cuda, front=0.3)
    gen = torch.Generator().manual_seed(8)
    B, T = 1, 1100
    cond = (torch.randn(B, T, 80, generator=gen) * 0.5).to(BF16).to(cuda)
    noise = (torch.rand(T, B, tc.n_mixtures + 1, generator=gen) * 0.998
             + 0.001).to(cuda)
    kw = dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures, head="mol",
              log_scale_min=tc.log_scale_min)
    got = ar_sample(cond, noise, w, **kw)
    want = ar_sample_reference(cond, noise, w, **kw)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    assert float(diff[:, :64].max()) <= 1e-3
    assert float(diff.max()) <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("body,dims,dtype", [
    ("wgmma", (128, 256, 128, 80), BF16), ("wgmma", (64, 128, 64, 80), BF16),
    ("generic", (64, 128, 64, 40), F32), ("wgmma", WIDE, BF16),
    ("generic", WIDE, F32),
])
@pytest.mark.parametrize("d", [1024, 2048])
@pytest.mark.parametrize("T", ["below", "above"])
def test_kernel5_takes_dilations_past_the_tile_on_card(cuda, body, dims,
                                                       dtype, d, T):
    """Kernel 5's "layer" epilogue at dilations 1,024 and 2,048, with T
    below d (every tap is padding) and above it (d + 300: the tap crosses
    from padding into the row), on the wgmma body (its TMA tap box at
    t0 - d) and the general body (cp.async tap rows), against the plain
    version per batch row (0.02 bf16, 1e-4 fp32: tests/test_torch_generic.py)."""
    from pwn_tpu_torch.ops.gated_layer import pack_layer  # noqa: F401

    C, G, S, M = dims
    assert fs.kernel_body(dtype, *dims) == body
    T = d // 2 if T == "below" else d + 300
    a = _stack_ops(dims, dtype, (d,), B=2, T=T, seed=d, device=cuda)
    top = [a[k][0] for k in ("w_in", "b_g", "w_out", "b_rs")]
    by = gated_layer.launches_by[(body, "layer")]
    with torch.inference_mode():
        got = gated_layer(a["x0"], a["cond"], *top, d)
        want = gated_layer_reference(a["x0"], a["cond"], *top, d)
    torch.cuda.synchronize()
    assert gated_layer.launches_by[(body, "layer")] == by + 1
    tol = 0.02 if dtype == BF16 else 1e-4
    for g, w in zip(got, want):
        assert (_row_rel(g, w) <= tol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_far_stack_runs_kernel5_layer_on_card(cuda, dtype):
    """A stack with dilations (1, 1024, 2048) asked for "train" runs "layer" on
    the card: three kernel-5 "layer" launches a forward, its gradient
    through the layers' recompute VJP, against the same stack's plain
    versions on the CPU (0.02 of the largest output in bf16, 1e-4 in
    fp32; the gradient of x within 2e-3 of its norm in fp32)."""
    port = WaveNetStack(FAR, 64, 128, 64, 2, 80, dtype=dtype,
                        mode=resolve_stack_mode("train", "train", FAR))
    assert port.mode == "layer"
    gen = torch.Generator().manual_seed(3)
    port.reset_parameters(gen)
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.uniform(-0.8, 0.8, (2, 2600, 1)).astype(
        np.float32))
    cond = torch.from_numpy(rng.uniform(0, 1, (2, 2600, 80)).astype(
        np.float32))
    outs = {}
    for dev in ("cpu", cuda):
        m = port.to(dev)
        xt = x.to(dev).requires_grad_(True)
        n = gated_layer.launches
        y = m(xt, cond.to(dev))
        (dx,) = torch.autograd.grad(y.sum(), [xt])
        outs[str(dev)[:3]] = (y.detach().cpu(), dx.cpu(),
                              gated_layer.launches - n)
    assert outs["cud"][2] == len(FAR) and outs["cpu"][2] == 0
    (yc, dxc, _), (yg, dxg, _) = outs["cpu"], outs["cud"]
    tol = 1e-4 if dtype == F32 else 0.02
    assert float((yg - yc).abs().max()) <= tol * float(yc.abs().max())
    if dtype == F32:
        assert float((dxg - dxc).norm()) <= 2e-3 * float(dxc.norm())
