"""The port's per-layer gated residual layer (kernel 5's module) against the
JAX reference: the layer's forward and custom-VJP gradients against the
Pallas kernel in interpret mode (as tests/test_pallas_kernels.py runs it),
the "layer" stack mode against the JAX stack with `fused=True`, the "infer"
stack at `large_student_sharded` widths (kernel 5's accumulate epilogue on
the card) against the JAX stack with `mega=True`, student synthesis with
`fused_layers="layer"`, the stack-mode choice, the `large_student_sharded`
tree and mel, and — on a CUDA card only — the hand-written kernel in both
epilogues against its plain version.

Inputs come from a numpy seed; parameters from JAX's initialisers through
`convert.params_from_flax`.  JAX is imported inside the tests and fixtures
that need it, so the CUDA cases also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gated_layer.py
"""

import numpy as np
import pytest
import torch

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.models.modules import WaveNetStack, resolve_stack_mode
from pwn_tpu_torch.models.student import StudentIAF, init_student
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.ops.flow_stack import (flow_stack_reference, kernel1_takes,
                                          layer_out)
from pwn_tpu_torch.ops.gated_layer import (KERNEL_DIMS, TIME_TILE,
                                           check_accumulate_args,
                                           check_gated_layer_args,
                                           flow_stack_by_layers,
                                           fused_gated_residual, gated_layer,
                                           gated_layer_accumulate,
                                           gated_layer_reference, pack_layer)
from torch_parity import jax_config

LARGE = get_config("large_student_sharded")
TINY = get_config("tiny_teacher")
PARAM_NAMES = ("w_dilated", "b_dilated", "w_cond", "b_cond", "w_res",
               "b_res", "w_skip", "b_skip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer_inputs(seed, B, T, C, M, G, S, scale=10.0):
    """x, cond and the eight layer parameters as float32 numpy arrays, in
    the distribution of tests/test_pallas_kernels.py (weights 0.1 N(0, 1),
    x and cond `scale` times that)."""
    rng = np.random.default_rng(seed)

    def mk(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    shapes = {"w_dilated": (2, C, G), "b_dilated": (G,), "w_cond": (M, G),
              "b_cond": (G,), "w_res": (G // 2, C), "b_res": (C,),
              "w_skip": (G // 2, S), "b_skip": (S,)}
    x, cond = mk(B, T, C, s=0.1 * scale), mk(B, T, M, s=0.1 * scale)
    return x, cond, {k: mk(*v) for k, v in shapes.items()}


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


@pytest.fixture(scope="module")
def jax_layer():
    pytest.importorskip("jax")
    from pwn_tpu.ops.pallas import gated_layer as jgl

    return jgl


@pytest.mark.parametrize("B,T,C,M,G,S,d", [
    (2, 700, 32, 16, 64, 48, 1),
    (1, 512, 16, 8, 32, 16, 64),
    (2, 1500, 16, 8, 32, 16, 512),
])
def test_forward_matches_pallas_fp32(jax_layer, B, T, C, M, G, S, d):
    """The shapes of tests/test_pallas_kernels.py, fp32, its tolerance
    (rtol 1e-4, atol 1e-5): only the summation order differs."""
    import jax.numpy as jnp

    x, cond, p = _layer_inputs(0, B, T, C, M, G, S)
    want = jax_layer.fused_gated_residual(
        jnp.asarray(x), jnp.asarray(cond),
        **{k: jnp.asarray(v) for k, v in p.items()}, dilation=d,
        interpret=True)
    with torch.no_grad():
        got = fused_gated_residual(_t(x), _t(cond),
                                   **{k: _t(v) for k, v in p.items()},
                                   dilation=d)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_forward_matches_pallas_bf16(jax_layer):
    """bf16 x and cond, fp32 parameters (both cast the weights to bf16 and
    keep the summed biases in fp32).  Both round z and out to bf16 and add
    x + out in bf16; only the fp32 summation order differs, which flips an
    occasional bf16 rounding: within 2 bf16 ulps of each output's max
    (2^-7 relative), and the two agree exactly on most elements."""
    import jax.numpy as jnp

    x, cond, p = _layer_inputs(1, 2, 600, 32, 16, 64, 32, scale=5.0)
    want = jax_layer.fused_gated_residual(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(cond, jnp.bfloat16),
        **{k: jnp.asarray(v) for k, v in p.items()}, dilation=8,
        interpret=True)
    with torch.no_grad():
        got = fused_gated_residual(_t(x, torch.bfloat16),
                                   _t(cond, torch.bfloat16),
                                   **{k: _t(v) for k, v in p.items()},
                                   dilation=8)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= 2 ** -7 * np.abs(w).max()
        assert (g == w).mean() > 0.9


# tiny_teacher's widths (40 mel bands): kernel 5's general body on the card
TINY_DIMS = (64, 128, 64, 40)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_matches_pallas_at_tiny_widths(jax_layer, dtype):
    """The "layer" epilogue's plain version at tiny_teacher's widths
    (64, 128, 64, 40) against the Pallas kernel in interpret mode, d = 16
    at T = 512.  float32: rtol 1e-4, atol 1e-5, as
    test_forward_matches_pallas_fp32; bfloat16: within 2 bf16 ulps of each
    output's max, as test_forward_matches_pallas_bf16."""
    import jax.numpy as jnp

    C, G, S, M = TINY_DIMS
    x, cond, p = _layer_inputs(40, 1, 512, C, M, G, S, scale=5.0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_layer.fused_gated_residual(
        jnp.asarray(x, jdt), jnp.asarray(cond, jdt),
        **{k: jnp.asarray(v) for k, v in p.items()}, dilation=16,
        interpret=True)
    with torch.no_grad():
        got = fused_gated_residual(_t(x, dtype), _t(cond, dtype),
                                   **{k: _t(v) for k, v in p.items()},
                                   dilation=16)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        else:
            assert np.abs(g - w).max() <= 2 ** -7 * np.abs(w).max()
            assert (g == w).mean() > 0.9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accumulate_chain_matches_pallas_at_tiny_widths(jax_layer, dtype):
    """The "accumulate" epilogue's plain version once per layer
    (`flow_stack_by_layers` on CPU tensors) at tiny_teacher's widths,
    three layers (d = 1, 16, 512 at T = 512: the last tap all padding),
    against the Pallas whole-stack kernel in interpret mode.  float32:
    rtol 1e-4, atol 1e-5; bfloat16: 1e-2 of the largest value, as
    tests/test_torch_flow_stack.py's bf16 comparison with that kernel."""
    import jax.numpy as jnp

    from pwn_tpu.ops.pallas.flow_stack import fused_flow_stack

    C, G, S, M = TINY_DIMS
    dil = (1, 16, 512)
    args = _stack_args(41, 3, torch.float32, B=1, T=512, C=C, G=G, S=S, M=M)
    args = {k: (v if k in ("b_g", "b_rs") else v.to(dtype))
            for k, v in args.items()}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = {k: jnp.asarray(v.float().numpy()).astype(
             jnp.float32 if k in ("b_g", "b_rs") else jdt)
         for k, v in args.items()}
    for k in ("w_in", "w_out"):   # JAX: (L, in, out)
        j[k] = jnp.swapaxes(j[k], 1, 2)
    want = np.asarray(fused_flow_stack(**j, dilations=dil, interpret=True)
                      .astype(jnp.float32))
    got = flow_stack_by_layers(**args, dilations=dil)
    assert got.dtype == dtype
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - want).max() < 1e-2 * np.abs(want).max()


def test_dilation_above_time_tile_raises(jax_layer):
    """The reference's API check, kept: a dilation above TIME_TILE raises
    ValueError naming it, in both packages."""
    import jax.numpy as jnp

    assert TIME_TILE == jax_layer.TIME_TILE
    x, cond, p = _layer_inputs(2, 1, 64, 8, 8, 16, 8)
    with pytest.raises(ValueError, match="TIME_TILE"):
        fused_gated_residual(_t(x), _t(cond),
                             **{k: _t(v) for k, v in p.items()},
                             dilation=TIME_TILE * 2)
    with pytest.raises(ValueError, match="TIME_TILE"):
        jax_layer.fused_gated_residual(
            jnp.asarray(x), jnp.asarray(cond),
            **{k: jnp.asarray(v) for k, v in p.items()},
            dilation=TIME_TILE * 2, interpret=True)


def _weighted_loss(res, skip, dres_w, dskip_w):
    return (res * dres_w).sum() + (skip * dskip_w).sum()


def test_custom_backward_matches_jax_vjp(jax_layer):
    """The port's FusedGatedResidual backward against JAX's custom VJP of
    the Pallas forward, for x, cond and every parameter (rtol 1e-3, atol
    1e-5, the reference's own gate, tests/test_pallas_kernels.py)."""
    import jax
    import jax.numpy as jnp

    B, T, C, M, G, S, d = 1, 600, 8, 4, 16, 8, 16
    x, cond, p = _layer_inputs(3, B, T, C, M, G, S, scale=1.0)
    rng = np.random.default_rng(4)
    dres_w = (rng.standard_normal((B, T, C)) * 0.1).astype(np.float32)
    dskip_w = (rng.standard_normal((B, T, S)) * 0.1).astype(np.float32)

    def jloss(x, cond, p):
        res, skip = jax_layer.fused_gated_residual(x, cond, **p, dilation=d,
                                                   interpret=True)
        return jnp.sum(res * dres_w) + jnp.sum(skip * dskip_w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(cond),
        {k: jnp.asarray(v) for k, v in p.items()})
    xt, ct = _t(x, grad=True), _t(cond, grad=True)
    pt = {k: _t(v, grad=True) for k, v in p.items()}
    res, skip = fused_gated_residual(xt, ct, **pt, dilation=d)
    assert type(res.grad_fn).__name__ == "FusedGatedResidualBackward"
    got = torch.autograd.grad(
        _weighted_loss(res, skip, _t(dres_w), _t(dskip_w)),
        [xt, ct, *(pt[k] for k in PARAM_NAMES)])
    want = [want[0], want[1], *(want[2][k] for k in PARAM_NAMES)]
    for name, g, w in zip(("x", "cond", *PARAM_NAMES), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("T,d", [(300, 7), (40, 40), (30, 100)])
def test_custom_backward_matches_autograd_of_the_plain_layer(T, d):
    """The custom backward equals autograd through the fp32 plain forward,
    also where the dilation reaches past the sequence (d >= T: the tap is
    all padding, and so is its cotangent)."""
    B, C, M, G, S = 2, 8, 4, 16, 8
    x, cond, p = _layer_inputs(5, B, T, C, M, G, S, scale=1.0)
    rng = np.random.default_rng(6)
    w_r = _t((rng.standard_normal((B, T, C)) * 0.1).astype(np.float32))
    w_s = _t((rng.standard_normal((B, T, S)) * 0.1).astype(np.float32))
    grads = []
    for custom in (True, False):
        xt, ct = _t(x, grad=True), _t(cond, grad=True)
        pt = {k: _t(v, grad=True) for k, v in p.items()}
        if custom:
            res, skip = fused_gated_residual(xt, ct, **pt, dilation=d)
        else:
            res, skip = gated_layer_reference(
                xt, ct, *pack_layer(*(pt[k] for k in PARAM_NAMES),
                                    torch.float32), d)
        grads.append(torch.autograd.grad(
            _weighted_loss(res, skip, w_r, w_s),
            [xt, ct, *(pt[k] for k in PARAM_NAMES)]))
    for name, a, b in zip(("x", "cond", *PARAM_NAMES), *grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def test_gradients_take_each_input_dtype():
    """Each gradient comes back in its input's dtype (bf16 x and cond, fp32
    parameters), as the reference's `cast(v, ref)`."""
    x, cond, p = _layer_inputs(7, 1, 50, 8, 4, 16, 8, scale=1.0)
    xt = _t(x, torch.bfloat16, grad=True)
    ct = _t(cond, torch.bfloat16, grad=True)
    pt = {k: _t(v, grad=True) for k, v in p.items()}
    res, skip = fused_gated_residual(xt, ct, **pt, dilation=3)
    grads = torch.autograd.grad(res.float().sum() + skip.float().sum(),
                                [xt, ct, *pt.values()])
    assert [g.dtype for g in grads] == ([torch.bfloat16] * 2
                                       + [torch.float32] * 8)
    assert all(torch.isfinite(g.float()).all() for g in grads)


def test_wrapper_on_cpu_is_the_reference_and_launches_nothing():
    x, cond, p = _layer_inputs(8, 2, 100, 16, 8, 32, 16)
    packed = pack_layer(*(_t(p[k]) for k in PARAM_NAMES), torch.float32)
    before = gated_layer.launches
    got = gated_layer(_t(x), _t(cond), *packed, 5)
    assert gated_layer.launches == before
    want = gated_layer_reference(_t(x), _t(cond), *packed, 5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_pack_layer_is_the_reference_layout():
    """`pack_layer` holds `_fused_forward`'s w_in = [w_dilated[1];
    w_dilated[0]; w_cond] and w_out = [w_res | w_skip], stored (out, in),
    and the summed biases in fp32 without rounding to the compute dtype."""
    _, _, p = _layer_inputs(9, 1, 1, 8, 4, 16, 8)
    pt = {k: _t(v) for k, v in p.items()}
    w_in, b_g, w_out, b_out = pack_layer(*(pt[k] for k in PARAM_NAMES),
                                         torch.bfloat16)
    want_in = np.concatenate([p["w_dilated"][1], p["w_dilated"][0],
                              p["w_cond"]]).T
    want_out = np.concatenate([p["w_res"], p["w_skip"]], axis=1).T
    assert w_in.dtype == w_out.dtype == torch.bfloat16
    assert b_g.dtype == b_out.dtype == torch.float32
    torch.testing.assert_close(w_in, _t(want_in, torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(w_out, _t(want_out, torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(b_g, pt["b_dilated"] + pt["b_cond"], rtol=0,
                               atol=0)
    torch.testing.assert_close(
        b_out, torch.cat([pt["b_res"], pt["b_skip"]]), rtol=0, atol=0)


def _kernel_args(B=2, T=256, dims=KERNEL_DIMS[1], seed=10):
    C, G, S, M = dims
    x, cond, p = _layer_inputs(seed, B, T, C, M, G, S, scale=5.0)
    packed = pack_layer(*(_t(p[k]) for k in PARAM_NAMES), torch.bfloat16)
    return dict(zip(("x", "cond", "w_in", "b_g", "w_out", "b_out"),
                    (_t(x, torch.bfloat16), _t(cond, torch.bfloat16),
                     *packed)))


@pytest.mark.parametrize("change,match", [
    (lambda a: a.update(x=a["x"].float()), "x must be bfloat16"),
    (lambda a: a.update(b_g=a["b_g"].bfloat16()), "b_g must be float32"),
    (lambda a: a.update(x=a["x"][..., :96], w_in=a["w_in"][:, 32:],
                        w_out=a["w_out"][32:]), "kernel is built for"),
    (lambda a: a.update(cond=a["cond"][:, :100]), "cond must be"),
    (lambda a: a.update(b_out=a["b_out"][:64]), "b_out must be"),
    (lambda a: a.update(w_out=a["w_out"][:, :64]), "w_out must be"),
    (lambda a: None, "CUDA device"),
])
def test_kernel_argument_checks(change, match):
    """What the kernel does not take raises before any launch, a width it
    is not built for included; a CPU tensor that reaches the kernel path is
    refused, never computed."""
    args = _kernel_args()
    change(args)
    with pytest.raises(ValueError, match=match):
        check_gated_layer_args(**args, dilation=4)


def test_kernel_argument_checks_dilation():
    with pytest.raises(ValueError, match="dilations >= 1"):
        check_gated_layer_args(**_kernel_args(), dilation=0)


def _jitter(module, seed):
    """Random parameters, every one jittered: a fresh init has zero biases."""
    gen = torch.Generator().manual_seed(seed)
    module.reset_parameters(gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return convert.params_to_flax(module.state_dict())


@pytest.mark.parametrize("dilations,C,G,S,M,T", [
    ((1, 2, 4, 64), 16, 32, 16, 8, 300),
    (tuple(2 ** i for i in range(10)), 128, 256, 128, 80, 600),
])
def test_layer_stack_matches_jax_fused_stack(jax_layer, dilations, C, G, S,
                                             M, T):
    """A WaveNetStack in mode "layer" against the JAX stack with
    fused=True (the Pallas per-layer kernel, interpret mode), fp32: at
    tiny widths, and at large_student_sharded's (10 layers, dilations to
    512, C=128, G=256, S=128, M=80).  1e-4: ten fp32 layers summed in
    another order."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.modules import WaveNetStack as JaxStack

    port = WaveNetStack(dilations, C, G, S, 2, M, mode="layer")
    params = _jitter(port, 0)
    jstack = JaxStack(dilations=dilations, residual_channels=C,
                      gate_channels=G, skip_channels=S, out_dim=2,
                      fused=True)
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.8, 0.8, (1, T, 1)).astype(np.float32)
    cond = rng.uniform(0, 1, (1, T, M)).astype(np.float32)
    want = jax.jit(jstack.apply)({"params": params}, jnp.asarray(x),
                                 jnp.asarray(cond))
    with torch.no_grad():
        got = port(_t(x), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_infer_stack_matches_jax_mega_stack(jax_layer, dtype, tol):
    """An "infer" WaveNetStack at large_student_sharded's widths (10 layers,
    dilations to 512, C=128, G=256, S=128, M=80; B=1, T=512) against the
    JAX stack with mega=True, the Pallas whole-stack kernel in interpret
    mode: both sum skip in fp32 and round it once, with b_g and b_rs rounded
    to the compute dtype.  float32: rtol and atol 1e-4, only the summation
    order differs (8e-7 of the output's max measured).  bfloat16: max|diff|
    within 0.02 of max|want|: the summation order flips an occasional bf16
    rounding of x or z, which ten layers and the bf16 heads carry (0.009
    measured)."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.modules import WaveNetStack as JaxStack

    dilations, (C, G, S, M) = tuple(2 ** i for i in range(10)), KERNEL_DIMS[1]
    port = WaveNetStack(dilations, C, G, S, 2, M, dtype=dtype)
    assert port.mode == "infer"
    params = _jitter(port, 0)
    jstack = JaxStack(dilations=dilations, residual_channels=C,
                      gate_channels=G, skip_channels=S, out_dim=2,
                      dtype=jnp.float32 if dtype == torch.float32
                      else jnp.bfloat16, mega=True)
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.8, 0.8, (1, 512, 1)).astype(np.float32)
    cond = rng.uniform(0, 1, (1, 512, M)).astype(np.float32)
    want = np.asarray(jax.jit(jstack.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(cond)))
    with torch.no_grad():
        got = port(_t(x), _t(cond)).numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _stack_args(seed, L, dtype, B=2, T=500, C=16, G=32, S=16, M=8):
    rng = np.random.default_rng(seed)

    def mk(*shape, s=0.2):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32))

    return dict(x0=mk(B, T, C, s=1.0).to(dtype),
                cond=mk(B, T, M, s=1.0).to(dtype),
                w_in=mk(L, G, 2 * C + M).to(dtype), b_g=mk(L, G),
                w_out=mk(L, C + S, G // 2).to(dtype), b_rs=mk(L, C + S))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dilations", [(1,), (1, 512), (1, 4, 64, 512)])
def test_accumulate_layer_by_layer_is_the_stack_reference(dtype, dilations):
    """The plain accumulate epilogue applied layer by layer over the stacked
    layout's per-layer views (`flow_stack_by_layers` on CPU tensors) is
    `flow_stack_reference` bit for bit: the same arithmetic in the same
    order, for one layer (first and last at once), two (a tap past the
    sequence) and four; the CPU path launches nothing."""
    args = _stack_args(20, len(dilations), dtype)
    before = gated_layer.launches
    got = flow_stack_by_layers(**args, dilations=dilations)
    assert gated_layer.launches == before
    want = flow_stack_reference(**args, dilations=dilations)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_accumulate_keeps_the_skip_sum_in_fp32():
    """One middle layer: skip_acc grows by the layer's unrounded fp32 skip
    (out[C:] + b), res is bf16(x + bf16(out[:C])); the last layer returns
    bf16(skip_acc + skip) and leaves skip_acc as it was."""
    a = _stack_args(21, 1, torch.bfloat16)
    layer = (a["x0"], a["cond"], a["w_in"][0], a["b_g"][0], a["w_out"][0],
             a["b_rs"][0], 3)
    C = a["x0"].shape[-1]
    out = layer_out(*layer)
    acc0 = torch.randn(out[..., C:].shape, generator=torch.Generator()
                       .manual_seed(0))
    acc = acc0.clone()
    res = gated_layer_accumulate(*layer, acc, first=False, last=False)
    torch.testing.assert_close(acc, acc0 + out[..., C:], rtol=0, atol=0)
    torch.testing.assert_close(
        res, a["x0"] + out[..., :C].bfloat16(), rtol=0, atol=0)
    acc = acc0.clone()
    skip = gated_layer_accumulate(*layer, acc, first=False, last=True)
    assert torch.equal(acc, acc0) and skip.dtype == torch.bfloat16
    torch.testing.assert_close(skip, (acc0 + out[..., C:]).bfloat16(),
                               rtol=0, atol=0)


def _acc_kernel_args(B=2, T=256, dims=KERNEL_DIMS[1]):
    args = _kernel_args(B, T, dims)
    args["b_rs"] = args.pop("b_out").bfloat16().float()
    return dict(args, skip_acc=torch.zeros((B, T, dims[2])),
                out=torch.empty((B, T, dims[0]), dtype=torch.bfloat16))


@pytest.mark.parametrize("change,match", [
    (lambda a: a.update(skip_acc=a["skip_acc"].bfloat16()),
     "skip_acc must be"),
    (lambda a: a.update(skip_acc=None), "skip_acc must be"),
    (lambda a: a.update(skip_acc=a["skip_acc"][:, :100]), "skip_acc must be"),
    (lambda a: a.update(out=a["out"][..., :64]), "out must be"),
    (lambda a: a.update(out=a["x"]), "must not overwrite x"),
    (lambda a: a.update(x=a["x"][..., :96], w_in=a["w_in"][:, 32:],
                        w_out=a["w_out"][32:], skip_acc=a["skip_acc"],
                        out=a["out"][..., :96].contiguous()),
     "kernel is built for"),
    (lambda a: None, "CUDA device"),
])
def test_accumulate_argument_checks(change, match):
    """What the accumulate epilogue does not take raises before any launch:
    its fp32 skip_acc and its output buffer, then the layer's operands."""
    args = _acc_kernel_args()
    change(args)
    with pytest.raises(ValueError, match=match):
        check_accumulate_args(**args, dilation=4, first=False, last=False)


@pytest.mark.parametrize("flag,context,mode", [
    ("mega", "train", "train"), ("mega", "infer", "infer"),
    ("auto", "train", "train"), ("auto", "infer", "infer"),
    ("mega_dx", "infer", "dx"), ("layer", "train", "layer"),
])
def test_resolve_stack_mode_in_context(flag, context, mode):
    """"mega" in a training context is the training stack, as the reference
    trains it (`mega_train`); in an inference context the inference
    stack."""
    assert resolve_stack_mode(flag, context) == mode


@pytest.mark.parametrize("dims,mode,want", [
    ((64, 128, 64, 80), "train", "train"),
    ((64, 128, 64, 80), "dx", "dx"),
    ((64, 128, 64, 80), "infer", "infer"),
    ((128, 256, 128, 80), "train", "train"),
    ((128, 256, 128, 80), "dx", "dx"),
    ((128, 256, 128, 80), "infer", "infer"),
    ((64, 128, 64, 40), "train", "train"),  # the general bodies on the card
    ((64, 128, 64, 40), "infer", "infer"),
])
def test_training_stack_mode_from_widths(dims, mode, want):
    """A stack keeps the mode it is built in at every width: kernels 2 and
    3 are built at the student's widths as at the teacher's, and the
    reference runs mega_train / mega_dx for every `mega_ok` stack, so a
    C=64 "train" or "dx" stack no longer becomes "layer"."""
    C, G, S, M = dims
    stack = WaveNetStack(tuple(2 ** i for i in range(10)), C, G, S, 2, M,
                         mode=mode)
    assert stack.mode == want


def test_tiny_teacher_keeps_train_in_a_training_context():
    """tiny_teacher (40 mel bands, which kernels 2 and 3 run through their
    general bodies on the card) in the training loop's context builds in
    "train" for "auto" and "mega", and its loss and gradients run on the
    CPU (the plain versions)."""
    from pwn_tpu_torch.training.teacher import prepare_batch

    for flag in ("auto", "mega"):
        cfg = override(TINY, "teacher.fused_layers", flag)
        port = init_teacher(cfg, torch.Generator().manual_seed(0),
                            stack_mode=resolve_stack_mode(flag, "train"),
                            device="cpu")
        assert port.stack.mode == "train"
    wav = torch.from_numpy(np.random.default_rng(3).uniform(
        -0.5, 0.5, (1, 1024)).astype(np.float32))
    loss = port.loss(*prepare_batch(wav, cfg))
    grads = torch.autograd.grad(loss, list(port.parameters()))
    assert np.isfinite(float(loss.detach()))
    assert all(torch.isfinite(g).all() for g in grads)


def test_layer_weights_are_cached_and_unrounded():
    """With grad off the per-layer weights are built once and reused until
    a parameter changes; their gate bias is b_dilated + b_cond in fp32,
    not rounded to the compute dtype as `stacked()` rounds it."""
    stack = WaveNetStack((1, 2), 16, 32, 16, 2, 8, dtype=torch.bfloat16,
                         mode="layer")
    with torch.no_grad():
        for lp in stack.layers:
            lp.b_dilated.normal_()
            lp.b_cond.normal_()
        a, b = stack.layer_weights(), stack.layer_weights()
        assert all(x is y for x, y in zip(a[0], b[0]))
        lp = stack.layer_0
        torch.testing.assert_close(a[0][1], lp.b_dilated + lp.b_cond,
                                   rtol=0, atol=0)
        assert not torch.equal(a[0][1], stack.stacked()[1][0])
        lp.b_cond.add_(1.0)
        c = stack.layer_weights()
    assert c[0][1] is not a[0][1]
    torch.testing.assert_close(c[0][1], lp.b_dilated + lp.b_cond, rtol=0,
                               atol=0)


def test_student_generate_from_z_with_layer_flag_matches_jax(jax_layer):
    """The slice as a whole: `StudentIAF.generate_from_z` with
    `student.fused_layers="layer"` against the JAX student with the same
    flag (its per-layer Pallas kernel, interpret mode) on a tiny config,
    2 flows x 3 layers, fp32, parameters carried by
    `convert.params_from_flax`; 1e-4 as tests/test_torch_student.py."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.student import make_student

    cfg = override(override(override(TINY, "student.n_flows", 2),
                            "student.layers_per_flow", 3),
                   "student.fused_layers", "layer")
    port = StudentIAF(cfg)
    assert [f.mode for f in port.flows] == ["layer", "layer"]
    params = _jitter(port, 2)
    model = make_student(jax_config(cfg))
    rng = np.random.default_rng(12)
    hop = cfg.dsp.hop_length
    mel = rng.uniform(0, 1, (2, 4, cfg.dsp.n_mels)).astype(np.float32)
    z = rng.logistic(0, 1, (2, 4 * hop)).astype(np.float32)
    want = jax.jit(lambda v, z, mel: model.apply(
        v, z, mel, method="generate_from_z"))(
        {"params": params}, jnp.asarray(z), jnp.asarray(mel))
    with torch.no_grad():
        got = port.generate_from_z(_t(z), _t(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name,flag,mode", [
    ("large_student_sharded", "auto", "infer"),
    ("large_student_sharded", "mega", "infer"),
    ("large_student_sharded", "layer", "layer"),
    ("student_iaf", "auto", "infer"),
    ("student_iaf", "mega", "infer"),
    ("student_iaf", "on", "layer"),
    ("student_iaf", "layer", "layer"),
    ("tiny_teacher", "auto", "infer"),  # 40 mel bands: the plain version
])
def test_student_stack_mode(name, flag, mode):
    """"auto" and "mega" are the whole-stack rounding at every width, as the
    reference's `mega_ok` keeps every preset on its megakernel (kernel 1 or
    kernel 5's accumulate loop on the card); "on" and "layer" ask for the
    per-layer rounding.  The same on every flow."""
    port = StudentIAF(override(get_config(name), "student.fused_layers",
                               flag))
    assert [f.mode for f in port.flows] == [mode] * len(port.flows)


@pytest.mark.parametrize("name,flag,mode", [
    ("teacher_lj", "auto", "infer"),
    ("teacher_lj", "mega", "infer"),
    ("teacher_lj", "layer", "layer"),
    ("teacher_lj", "mega_train", "train"),
    ("tiny_teacher", "on", "layer"),
    ("tiny_teacher", "auto", "infer"),
])
def test_teacher_stack_mode(name, flag, mode):
    port = TeacherWaveNet(override(get_config(name), "teacher.fused_layers",
                                   flag))
    assert port.stack.mode == mode


@pytest.mark.parametrize("dims,dilations,want", [
    ((64, 128, 64, 80), tuple(2 ** i for i in range(10)), True),
    ((128, 256, 128, 80), tuple(2 ** i for i in range(10)), False),
    ((64, 128, 64, 40), tuple(2 ** i for i in range(10)), False),
    ((64, 128, 64, 80), (1024,), False),
    ((64, 128, 64, 80), (1,) * 33, False),
    ((64, 128, 64, 80), (512,) * 3, False),  # rings past shared memory
    ((64, 128, 64, 80), (512,) * 2, True),
])
def test_kernel1_takes(dims, dilations, want):
    C, G, S, M = dims
    assert kernel1_takes(dilations, C, G, S, M) is want


def test_layer_mode_refuses_a_dilation_above_the_tile():
    """The per-layer API refuses a dilation above the tile, like the
    reference's; a stack with one resolves to "layer" in every mode asked
    for (and refuses another mode built directly), the counterpart of the
    reference's XLA per-layer form, which runs it through
    `FusedGatedResidual` (kernel 5 takes any dilation), and on the CPU
    matches that stack's plain per-layer form."""
    for mode in ("infer", "layer", "train", "dx"):
        assert resolve_stack_mode(mode, "infer", (1, 1024)) == "layer"
        if mode != "layer":
            with pytest.raises(ValueError, match="resolve_stack_mode"):
                WaveNetStack((1, 1024), 64, 128, 64, 2, 80, mode=mode)
    stack = WaveNetStack((1, 1024), 8, 16, 8, 2, 4, mode="layer")
    stack.reset_parameters(torch.Generator().manual_seed(0))
    x, cond = torch.rand(1, 1100, 1), torch.rand(1, 1100, 4)
    layer = stack.layers[1]
    with pytest.raises(ValueError, match="TIME_TILE"):
        fused_gated_residual(torch.rand(1, 1100, 8), cond,
                             *(getattr(layer, n) for n in PARAM_NAMES),
                             dilation=1024)
    with torch.no_grad():
        h = stack.front(x)
        skip = 0
        for lp, d in zip(stack.layers, stack.dilations):
            h, s = gated_layer_reference(h, cond, *pack_layer(
                *(getattr(lp, n) for n in PARAM_NAMES), torch.float32), d)
            skip = skip + s
        want = stack.head2(torch.relu(stack.head1(torch.relu(skip))))
        torch.testing.assert_close(stack(x, cond), want, rtol=1e-6,
                                   atol=1e-6)


def test_teacher_trains_through_the_layer_kernel():
    """`teacher.fused_layers="layer"` builds the teacher in mode "layer",
    and under autograd (the layers' custom backward) its loss and every
    gradient match jax.grad of the reference's loss on the batch of
    tests/test_torch_training.py (two 2048-sample crops), fp32: the loss
    within 1e-5 relative, each gradient within 2e-3 of its norm, that
    file's gate (the MoL gradient cancels to ~1e-5 of its terms, so fp32
    rounding leaves that much noise in every gradient)."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.teacher import make_teacher
    from pwn_tpu.training.teacher import prepare_batch as jax_prepare
    from pwn_tpu_torch.training.teacher import prepare_batch

    cfg = override(TINY, "teacher.fused_layers", "layer")
    jcfg = jax_config(override(cfg, "teacher.fused_layers", "off"))
    port = init_teacher(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert port.stack.mode == "layer"
    model = make_teacher(jcfg, use_scan=False)
    wav = np.random.default_rng(1).uniform(-0.6, 0.6, (2, 2048)).astype(
        np.float32)
    x, mel = jax_prepare(jnp.asarray(wav), jcfg)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: model.apply(
        {"params": p}, x, mel, method="loss")))(
        convert.params_to_flax(port.state_dict()))
    want = convert.params_from_flax(jax.tree.map(np.asarray, want))
    loss = port.loss(*prepare_batch(torch.from_numpy(wav), cfg))
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        assert float((g - want[n]).norm()) <= 2e-3 * float(want[n].norm()), n


def test_large_student_sharded_tree_round_trip():
    """The full large_student_sharded student tree (6 flows of front / ten
    C=128 layers / heads, the 24 kHz upsampler) maps flax -> port -> flax
    unchanged."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models.student import make_student

    hop = LARGE.dsp.hop_length
    shapes = jax.eval_shape(
        make_student(jax_config(LARGE)).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4 * hop)), jnp.zeros((1, 4, LARGE.dsp.n_mels)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = convert.params_from_flax(tree)
    assert tuple(sd["flow_5.layer_9.w_dilated"].shape) == (2, 128, 256)
    assert "flow_6.front.kernel" not in sd
    port = StudentIAF(LARGE)
    port.load_state_dict(sd, strict=True)
    back = convert.params_to_flax(port.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_mel_at_24khz_matches_jax(rng):
    """large_student_sharded's conditioning: the mel filterbank at 24 kHz,
    within the mutual tolerance of the reference's mel pipelines."""
    from pwn_tpu.generate import mel_from_wav as jax_mel_from_wav
    from pwn_tpu_torch.generate import mel_from_wav

    wav = np.clip(rng.standard_normal(4000) * 0.3, -1, 1).astype(np.float32)
    got = mel_from_wav(LARGE, wav, device="cpu").numpy()
    want = np.asarray(jax_mel_from_wav(jax_config(LARGE), wav))
    assert got.shape == want.shape == (1, 4000 // LARGE.dsp.hop_length, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_initialisers_default_to_the_card():
    """With no device, `init_student` puts the model on the CUDA card, and
    raises where there is none: the CPU only when asked for."""
    gen = torch.Generator().manual_seed(0)
    cfg = override(TINY, "student.n_flows", 1)
    if torch.cuda.is_available():
        assert next(init_student(cfg, gen).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_student(cfg, gen)
    assert next(init_student(cfg, gen, device="cpu").parameters()).device \
        == torch.device("cpu")


def test_mel_from_wav_defaults_to_the_card():
    """`mel_from_wav` with no device computes on the CUDA card, as the
    initialisers do, and raises where there is none: the CPU only when
    asked for."""
    from pwn_tpu_torch.generate import mel_from_wav

    wav = np.zeros(4 * TINY.dsp.hop_length, np.float32)
    if torch.cuda.is_available():
        assert mel_from_wav(TINY, wav).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mel_from_wav(TINY, wav)
    mel = mel_from_wav(TINY, wav, device="cpu")
    assert mel.device == torch.device("cpu")
    assert mel.shape == (1, 4, TINY.dsp.n_mels)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("dims", KERNEL_DIMS)
@pytest.mark.parametrize("B,T,d", [(2, 4096, 1), (2, 4096, 512), (1, 1, 1),
                                   (3, 700, 64), (1, 300, 300),
                                   (2, 100, 512)])
def test_kernel_matches_reference_on_card(cuda, dims, B, T, d):
    """bf16 kernel vs the plain version in fp32 on the same operands, per
    batch row: max|diff| / max|ref| within 0.02 for res and skip (the bound
    chip_smoke.py states), and bit-equal rows where the plain version
    runs in bf16 on most elements."""
    args = {k: v.to(cuda) for k, v in _kernel_args(B, T, dims).items()}
    before = gated_layer.launches
    with torch.inference_mode():
        out = gated_layer(**args, dilation=d)
        ref = gated_layer_reference(
            *(v.float() for v in args.values()), dilation=d)
    torch.cuda.synchronize()
    assert gated_layer.launches == before + 1
    for o, r in zip(out, ref):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        err = (o.float() - r).abs().reshape(B, -1).amax(1)
        scale = r.abs().reshape(B, -1).amax(1) + 1e-6
        assert (err / scale <= 0.02).all(), (err / scale).tolist()


@pytest.mark.gpu
def test_kernel_unbuilt_width_raises_on_card(cuda):
    """Operands neither body takes (fp16: the wgmma body is bf16 only, the
    general body fp32 or bf16) raise on the card, in both epilogues; a
    width the wgmma body is not built for now goes to the general body."""
    args = {k: (v.half() if k in ("x", "cond", "w_in", "w_out") else v)
            .to(cuda) for k, v in _kernel_args(dims=(32, 64, 32, 80)).items()}
    with pytest.raises(ValueError, match="no kernel body takes"):
        gated_layer(**args, dilation=1)
    with pytest.raises(ValueError, match="no kernel body takes"):
        gated_layer_accumulate(*args.values(), 1, None, first=True,
                               last=True)


@pytest.mark.gpu
def test_layer_gradient_on_card(cuda):
    """FusedGatedResidual with the kernel forward on the card: the custom
    backward against autograd through the fp32 plain version, every input
    and parameter, relative L2 within 0.02 (the forward's bf16 rounding
    does not reach the backward, which recomputes in fp32 from the same
    bf16 x and cond)."""
    C, G, S, M = KERNEL_DIMS[1]
    x, cond, p = _layer_inputs(13, 2, 2048, C, M, G, S, scale=5.0)
    rng = np.random.default_rng(14)
    w_r = _t(rng.standard_normal((2, 2048, C)).astype(np.float32)).to(cuda)
    w_s = _t(rng.standard_normal((2, 2048, S)).astype(np.float32)).to(cuda)
    grads = []
    for custom in (True, False):
        xt = _t(x, torch.bfloat16).to(cuda)
        ct = _t(cond, torch.bfloat16).to(cuda)
        if not custom:
            xt, ct = xt.float(), ct.float()
        xt.requires_grad_(True)
        ct.requires_grad_(True)
        pt = {k: _t(v).to(cuda).requires_grad_(True) for k, v in p.items()}
        if custom:
            res, skip = fused_gated_residual(xt, ct, **pt, dilation=64)
        else:
            res, skip = gated_layer_reference(
                xt, ct, *pack_layer(*(pt[k] for k in PARAM_NAMES),
                                    torch.float32), 64)
        loss = (res.float() * w_r).sum() + (skip.float() * w_s).sum()
        grads.append(torch.autograd.grad(loss, [xt, ct, *pt.values()]))
    for name, a, b in zip(("x", "cond", *PARAM_NAMES), *grads):
        rel = float((a.float() - b).norm() / b.norm())
        assert rel <= 0.02, (name, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", KERNEL_DIMS)
@pytest.mark.parametrize("B,T", [(2, 4096), (1, 1), (3, 700), (1, 300)])
def test_accumulate_matches_reference_on_card(cuda, dims, B, T):
    """The accumulate epilogue over a 3-layer chain (d = 1, 64, 512), each
    layer against the plain version in fp32 on the kernel's own inputs, per
    batch row: max|diff| / max|ref| within 0.02 for the output and for
    skip_acc after the layer; the last layer leaves skip_acc as it was."""
    C, G, S, M = dims
    x, cond, p = _layer_inputs(30, B, T, C, M, G, S, scale=5.0)
    x = _t(x, torch.bfloat16).to(cuda)
    cond = _t(cond, torch.bfloat16).to(cuda)
    acc = torch.empty((B, T, S), device=cuda)
    before = gated_layer.launches

    def rel(o, r):
        err = (o.float().cpu() - r).abs().reshape(B, -1).amax(1)
        return err / (r.abs().reshape(B, -1).amax(1) + 1e-6)

    for l, d in enumerate((1, 64, 512)):
        first, last = l == 0, l == 2
        w_in, b_g, w_out, b_rs = pack_layer(
            *(_t(p[k]) * (1 + 0.1 * l) for k in PARAM_NAMES), torch.bfloat16)
        ops = [w_in, b_g.bfloat16().float(), w_out, b_rs.bfloat16().float()]
        acc_before = acc.cpu()
        acc_ref = acc_before.clone()
        with torch.inference_mode():
            got = gated_layer_accumulate(
                x, cond, *(t.to(cuda) for t in ops), d, acc, first=first,
                last=last)
            want = gated_layer_accumulate(
                x.float().cpu(), cond.float().cpu(),
                *(t.float() for t in ops), d, acc_ref, first=first, last=last)
        torch.cuda.synchronize()
        assert (rel(got, want) <= 0.02).all(), (l, rel(got, want).tolist())
        if last:
            assert torch.equal(acc.cpu(), acc_before)
        else:
            assert (rel(acc, acc_ref) <= 0.02).all(), (l, rel(acc, acc_ref))
        x = got
    assert gated_layer.launches == before + 3
