"""The port's training stack: the plain forward-with-save and fused-backward
versions and kernel 2's route (kernel 5's accumulate epilogue once per
layer) against the JAX Pallas train kernels (interpret mode, as the
reference's own CPU tests run them), the plain weight-gradient GEMM, the
autograd wrapper against torch.autograd, the wrappers' dispatch and
argument checks, and — on a CUDA card only — kernels 2 and 3 and the
weight-gradient GEMM against their plain versions and torch.matmul.

JAX is imported inside the fixture that needs it, so the CUDA cases also
run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_flow_stack_train.py
"""

import numpy as np
import pytest
import torch

from pwn_tpu_torch.ops.flow_stack import (
    TRAIN_KERNEL_DIMS, check_kernel_args, check_train_backward_args,
    flow_stack_backward_reference, flow_stack_reference, flow_stack_score,
    flow_stack_train, flow_stack_train_backward, flow_stack_train_forward,
    flow_stack_train_reference, flow_stack_train_wgrads,
    flow_stack_wgrads_reference)
from pwn_tpu_torch.ops.gated_layer import (flow_stack_train_by_layers,
                                           gated_layer)

SMALL = dict(B=2, C=16, M=8, G=32, S=16)
TEACHER_DILATIONS = tuple(2 ** (i % 8) for i in range(24))
STUDENT_DILATIONS = tuple(2 ** i for i in range(10))
STUDENT_DIMS, TEACHER_DIMS, WIDE_DIMS = TRAIN_KERNEL_DIMS
# the training kernels' three widths and the stacks built at each (the
# wide teacher is teacher_lj's stack at 256 / 512 / 256 channels)
TRAIN_STACKS = {STUDENT_DIMS: STUDENT_DILATIONS,
                TEACHER_DIMS: TEACHER_DILATIONS,
                WIDE_DIMS: TEACHER_DILATIONS}
# the reference's own train-kernel cases (tests/test_flow_stack.py)
CASES = [
    ((1, 2, 4, 8), 1536),                     # multi-tile, growing dilations
    ((1, 2, 4, 512), 1100),                   # full-tile dilation, ragged T
    (tuple(2 ** i for i in range(10)), 2048),  # student-shaped
]
GRADS = ("dx", "dcond", "dw_in", "db_g", "dw_out", "db_rs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it (measured ~60x slower
    than alone), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, C, M, G, S, dilations):
    """JAX-layout operands ((L, in, out) weights) and a skip cotangent."""
    rng = np.random.default_rng(seed)
    L = len(dilations)

    def mk(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(
        x0=mk(B, T, C, scale=1.0), cond=mk(B, T, M, scale=1.0),
        w_in=mk(L, 2 * C + M, G), b_g=mk(L, G),
        w_out=mk(L, G // 2, C + S), b_rs=mk(L, C + S),
        dskip=mk(B, T, S, scale=1.0),
    )


def _torch(args, dtype=torch.float32, device="cpu"):
    """The wrappers' layout: JAX weights transposed to (out, in), biases
    float32, the rest `dtype`."""
    out = {}
    for k, v in args.items():
        t = torch.from_numpy(v)
        if k in ("w_in", "w_out"):
            t = t.transpose(1, 2).contiguous()
        out[k] = t.to(device, torch.float32 if k in ("b_g", "b_rs") else dtype)
    return out


def _fwd(args):
    return {k: v for k, v in args.items() if k != "dskip"}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def jax_train():
    pytest.importorskip("jax")
    from pwn_tpu.ops.pallas.flow_stack import (_flow_stack_train_bwd_impl,
                                               _flow_stack_train_fwd_impl)

    return _flow_stack_train_fwd_impl, _flow_stack_train_bwd_impl


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda()


def _jax_fwd_bwd(jax_train, args, dil, want_wgrads):
    """The JAX train forward and backward in interpret mode, on float32."""
    import jax.numpy as jnp

    fwd, bwd = jax_train
    j = {k: jnp.asarray(v) for k, v in args.items()}
    skip, acts, pad = fwd(dil, True, j["x0"], j["cond"], j["w_in"], j["b_g"],
                          j["w_out"], j["b_rs"])
    T = args["x0"].shape[1]
    cond, dskip = j["cond"], j["dskip"]
    if pad:
        cond = jnp.pad(cond, ((0, 0), (0, pad), (0, 0)))
        dskip = jnp.pad(dskip, ((0, 0), (0, pad), (0, 0)))
    grads = bwd(dil, True, acts, cond, j["w_in"], j["b_g"], j["w_out"],
                dskip, want_wgrads=want_wgrads)
    grads = [np.asarray(g) for g in grads]
    grads[0], grads[1] = grads[0][:, :T], grads[1][:, :T]
    return np.asarray(skip), np.asarray(acts)[:, :, :T], grads


@pytest.mark.parametrize("dil,T", CASES)
def test_plain_train_matches_pallas_fp32(jax_train, dil, T):
    """float32, both backward modes.  The two differ only in summation
    order (the Pallas kernel sums over 512-row tiles, the plain version
    over the whole sequence): 1e-5 relative forward, 1e-4 for gradients
    summed over ~3000 rows."""
    args = _inputs(0, T=T, dilations=dil, **SMALL)
    t = _torch(args)
    skip, acts = flow_stack_train_reference(**_fwd(t), dilations=dil)
    for want in (True, False):
        j_skip, j_acts, j_grads = _jax_fwd_bwd(jax_train, args, dil, want)
        if want:
            assert _rel(skip.numpy(), j_skip) < 1e-5
            assert _rel(acts.numpy(), j_acts) < 1e-5
        got = flow_stack_backward_reference(
            acts, t["cond"], t["w_in"], t["b_g"], t["w_out"], t["dskip"],
            dilations=dil, want_wgrads=want)
        assert len(got) == len(j_grads) == (6 if want else 2)
        for name, g, w in zip(GRADS, got, j_grads):
            if name in ("dw_in", "dw_out"):   # JAX: (L, in, out)
                w = np.swapaxes(w, 1, 2)
            assert g.shape == w.shape, name
            assert _rel(g.numpy(), w) < 1e-4, name


@pytest.mark.parametrize("want", [True, False])
def test_plain_backward_matches_pallas_at_student_widths(jax_train, want):
    """The plain backward at student_iaf's widths (64, 128, 64, 80), which
    kernel 3 is built for too, against the JAX backward in interpret mode,
    float32, with the student's ten dilations to 512 at T = 300: the top
    five layers' taps read only zeros, and their tap cotangents fall past
    the end.  Bounds as test_plain_train_matches_pallas_fp32."""
    C, G, S, M = STUDENT_DIMS
    dil, T = STUDENT_DILATIONS, 300
    args = _inputs(8, 1, T, C, M, G, S, dil)
    t = _torch(args)
    _, acts = flow_stack_train_reference(**_fwd(t), dilations=dil)
    _, j_acts, j_grads = _jax_fwd_bwd(jax_train, args, dil, want)
    assert _rel(acts.numpy(), j_acts) < 1e-5
    got = flow_stack_backward_reference(
        acts, t["cond"], t["w_in"], t["b_g"], t["w_out"], t["dskip"],
        dilations=dil, want_wgrads=want)
    assert len(got) == len(j_grads) == (6 if want else 2)
    for name, g, w in zip(GRADS, got, j_grads):
        if name in ("dw_in", "dw_out"):
            w = np.swapaxes(w, 1, 2)
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) < 1e-4, name


def test_plain_train_matches_pallas_bf16(jax_train):
    """bfloat16 in the rounding order both keep (dout, dg, z and the
    forward's x and z rounded; fp32 sums).  The Pallas backward also rounds
    the tap cotangent crossing a tile and dx crossing a layer chunk, which
    the port keeps fp32.  Flipped bf16 roundings are carried by the later
    layers: gaps of 0.0006-0.0055 of the largest value, bounded at 1e-2,
    the forward bound of test_torch_flow_stack.py."""
    import jax.numpy as jnp

    dil, T = CASES[0]
    args = _inputs(1, T=T, dilations=dil, **SMALL)
    t = _torch(args, torch.bfloat16)
    skip, acts = flow_stack_train_reference(**_fwd(t), dilations=dil)
    got = flow_stack_backward_reference(
        acts, t["cond"], t["w_in"], t["b_g"], t["w_out"], t["dskip"],
        dilations=dil)
    fwd, bwd = jax_train
    j = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in args.items()}
    j_skip, j_acts, _ = fwd(dil, True, j["x0"], j["cond"], j["w_in"],
                            j["b_g"].astype(jnp.float32), j["w_out"],
                            j["b_rs"].astype(jnp.float32))
    want = bwd(dil, True, j_acts, j["cond"], j["w_in"],
               j["b_g"].astype(jnp.float32), j["w_out"], j["dskip"])
    assert _rel(skip.float().numpy(), np.asarray(j_skip, np.float32)) < 1e-2
    for name, g, w in zip(GRADS, got, want):
        w = np.asarray(w, np.float32)
        if name in ("dw_in", "dw_out"):
            w = np.swapaxes(w, 1, 2)
        assert _rel(g.float().numpy(), w) < 1e-2, name


# tiny_teacher's widths (40 mel bands), which kernels 2 and 3 run through
# their general bodies on the card; three layers, the last one's tap and
# its cotangent past T
TINY_DIMS, TINY_DILATIONS, TINY_T = (64, 128, 64, 40), (1, 16, 512), 512


@pytest.mark.parametrize("want", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_train_matches_pallas_at_tiny_widths(jax_train, dtype, want):
    """The plain forward-with-save and backward at tiny_teacher's widths
    (64, 128, 64, 40), both backward modes, against the JAX train kernels
    in interpret mode.  float32: the JAX tests' rtol 1e-4, atol 1e-5 (only
    the summation order differs).  bfloat16: within 1e-2 of the largest
    value, test_plain_train_matches_pallas_bf16's bound."""
    import jax.numpy as jnp

    C, G, S, M = TINY_DIMS
    dil = TINY_DILATIONS
    args = _inputs(9, 1, TINY_T, C, M, G, S, dil)
    t = _torch(args, dtype)
    skip, acts = flow_stack_train_reference(**_fwd(t), dilations=dil)
    got = flow_stack_backward_reference(
        acts, t["cond"], t["w_in"], t["b_g"], t["w_out"], t["dskip"],
        dilations=dil, want_wgrads=want)
    if dtype == torch.float32:
        j_skip, j_acts, want_grads = _jax_fwd_bwd(jax_train, args, dil, want)
    else:
        fwd, bwd = jax_train
        j = {k: jnp.asarray(v).astype(jnp.float32 if k in ("b_g", "b_rs")
                                      else jnp.bfloat16)
             for k, v in args.items()}
        j_skip, j_acts, _ = fwd(dil, True, j["x0"], j["cond"], j["w_in"],
                                j["b_g"], j["w_out"], j["b_rs"])
        want_grads = bwd(dil, True, j_acts, j["cond"], j["w_in"], j["b_g"],
                         j["w_out"], j["dskip"], want_wgrads=want)
    assert len(got) == len(want_grads) == (6 if want else 2)
    pairs = [("skip", skip, j_skip), ("acts", acts, j_acts),
             *zip(GRADS, got, want_grads)]
    for name, g, w in pairs:
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if name in ("dw_in", "dw_out"):   # JAX: (L, in, out)
            w = np.swapaxes(w, 1, 2)
        assert g.shape == w.shape, name
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            assert _rel(g, w) < 1e-2, name


@pytest.mark.parametrize("dil,T", CASES)
def test_kernel2_route_matches_plain_and_pallas(jax_train, dil, T):
    """Kernel 2's route on a CUDA tensor is kernel 5's accumulate epilogue
    once per layer with each residual written into acts[l + 1]
    (`flow_stack_train_by_layers`).  On CPU tensors each layer is the plain
    accumulate epilogue: the same arithmetic as
    `flow_stack_train_reference`, so bit-equal to it in fp32 and bf16; and
    against the JAX train forward (interpret mode, fp32) within 1e-5 of
    the largest value, the summation-order bound of
    test_plain_train_matches_pallas_fp32."""
    args = _inputs(7, T=T, dilations=dil, **SMALL)
    for dtype in (torch.float32, torch.bfloat16):
        t = _fwd(_torch(args, dtype))
        skip, acts = flow_stack_train_by_layers(**t, dilations=dil)
        ref_skip, ref_acts = flow_stack_train_reference(**t, dilations=dil)
        torch.testing.assert_close(skip, ref_skip, rtol=0, atol=0)
        torch.testing.assert_close(acts, ref_acts, rtol=0, atol=0)
    t = _fwd(_torch(args))
    skip, acts = flow_stack_train_by_layers(**t, dilations=dil)
    j_skip, j_acts, _ = _jax_fwd_bwd(jax_train, args, dil, False)
    assert _rel(skip.numpy(), j_skip) < 1e-5
    assert _rel(acts.numpy(), j_acts) < 1e-5


@pytest.mark.parametrize("B,T,d", [(1, 1, 1), (3, 67, 5), (2, 40, 64)])
def test_wgrads_reference_is_the_outer_products(B, T, d):
    """The plain weight-gradient GEMM against the sums written out per row
    (numpy, float64): dW_in = sum_r dg[r]^T [x | x(t - d) | cond][r] with
    the tap zero for t < d (also d >= T), db_g = sum dg, dW_out = sum dout^T
    z, db_rs = sum dout; fp32 against float64 within 1e-5 relative."""
    C, M, G, S = 16, 8, 32, 16
    rng = np.random.default_rng(B * 1000 + T + d)
    x, cond = rng.standard_normal((B, T, C)), rng.standard_normal((B, T, M))
    dg, dout = rng.standard_normal((B, T, G)), rng.standard_normal((B, T, C + S))
    z = rng.standard_normal((B, T, G // 2))
    got = flow_stack_wgrads_reference(
        *(torch.from_numpy(a).float() for a in (x, cond, dg, dout, z)), d)
    tap = np.zeros_like(x)
    tap[:, d:] = x[:, :max(T - d, 0)]
    cat = np.concatenate([x, tap, cond], -1)
    want = (np.einsum("btg,btk->gk", dg, cat), dg.sum((0, 1)),
            np.einsum("btn,btk->nk", dout, z), dout.sum((0, 1)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) < 1e-5


@pytest.mark.parametrize("fn", [flow_stack_train, flow_stack_score])
def test_autograd_wrapper_matches_torch_autograd(fn):
    """The Function's gradients against torch.autograd through the plain
    inference stack, float32 (1e-5 relative: summation order).  The
    scoring variant gives dx and dcond only."""
    dil = (1, 2, 4, 32, 64)
    base = _torch(_inputs(2, T=300, dilations=dil, **SMALL))
    ct = base.pop("dskip")
    names = list(base)
    a = {k: v.clone().requires_grad_() for k, v in base.items()}
    want = torch.autograd.grad(flow_stack_reference(**a, dilations=dil),
                               list(a.values()), ct)
    b = {k: v.clone().requires_grad_() for k, v in base.items()}
    out = fn(**b, dilations=dil)
    torch.testing.assert_close(out, flow_stack_reference(**base,
                                                         dilations=dil),
                               rtol=0, atol=0)
    got = torch.autograd.grad(out, list(b.values()), ct, allow_unused=True)
    for name, g, w in zip(names, got, want):
        if fn is flow_stack_score and name not in ("x0", "cond"):
            assert g is None, name
            continue
        assert _rel(g.numpy(), w.numpy()) < 1e-5, name


def test_autograd_casts_weight_grads_to_the_weights_dtype():
    """The backward returns fp32 weight gradients; autograd hands each
    input a gradient of its own dtype (the JAX VJP's dW.astype(w.dtype))."""
    dil = (1, 2)
    t = _torch(_inputs(3, T=64, dilations=dil, **SMALL), torch.bfloat16)
    t.pop("dskip")
    leaves = {k: v.clone().requires_grad_() for k, v in t.items()}
    flow_stack_train(**leaves, dilations=dil).float().sum().backward()
    for k, v in leaves.items():
        assert v.grad is not None and v.grad.dtype == v.dtype, k
    assert leaves["w_in"].grad.dtype == torch.bfloat16
    assert leaves["b_g"].grad.dtype == torch.float32


def _counters():
    """Kernel 5's launches (kernel 2's, one per layer), kernel 3's calls,
    and the weight-gradient GEMM's."""
    return (gated_layer.launches, flow_stack_train_backward.launches,
            flow_stack_train_wgrads.launches)


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    dil = CASES[0][0]
    t = _torch(_inputs(4, T=200, dilations=dil, **SMALL))
    before = _counters()
    skip, acts = flow_stack_train_forward(**_fwd(t), dilations=dil)
    ref_skip, ref_acts = flow_stack_train_reference(**_fwd(t), dilations=dil)
    torch.testing.assert_close(skip, ref_skip, rtol=0, atol=0)
    torch.testing.assert_close(acts, ref_acts, rtol=0, atol=0)
    bargs = (acts, t["cond"], t["w_in"], t["b_g"], t["w_out"], t["dskip"])
    for want in (True, False):
        got = flow_stack_train_backward(*bargs, dilations=dil,
                                        want_wgrads=want)
        ref = flow_stack_backward_reference(*bargs, dilations=dil,
                                            want_wgrads=want)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    z = torch.zeros(acts.shape[1:3] + (t["w_out"].shape[-1],))
    dout = torch.ones(acts.shape[1:3] + (t["w_out"].shape[1],))
    dg = torch.ones(acts.shape[1:3] + (t["w_in"].shape[1],))
    got = flow_stack_train_wgrads(acts[1], t["cond"], dg, dout, z, dil[1])
    ref = flow_stack_wgrads_reference(acts[1], t["cond"], dg, dout, z, dil[1])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert _counters() == before


def _teacher_shaped(B=2, T=64, dtype=torch.bfloat16, device="cpu",
                    dims=TEACHER_DIMS):
    """Operands at one of the training kernels' widths (teacher_lj's by
    default, or student_iaf's) and that stack's dilations, in chip_smoke.py's
    distribution: x0 and cond of std 0.5, weights scaled by 1/sqrt(fan_in),
    so the gate pre-activations have unit variance."""
    C, G, S, M = dims
    args = _inputs(5, B, T, C, M, G, S, TRAIN_STACKS[dims])
    for name, fan_in in (("w_in", 2 * C + M), ("w_out", G // 2)):
        args[name] *= 10 / np.sqrt(fan_in)   # from std 0.1
    for name in ("x0", "cond"):
        args[name] *= 0.5
    return _torch(args, dtype, device)


@pytest.mark.parametrize("change,match", [
    (lambda a: a.update(x0=a["x0"].float()), "x0 must be bfloat16"),
    (lambda a: a.update(b_rs=a["b_rs"].bfloat16()), "b_rs must be float32"),
    (lambda a: a.update(x0=a["x0"][..., :64].contiguous(),
                        w_in=a["w_in"][..., 64:].contiguous()),
     "kernel is built for"),
    (lambda a: a.update(cond=a["cond"][:, :10]), "cond must be"),
    (lambda a: None, "CUDA device"),
])
def test_train_kernel_argument_checks(change, match):
    """What kernel 2 does not take raises before any launch; a CPU tensor
    that reaches the kernel path is refused, never computed."""
    args = _teacher_shaped()
    args.pop("dskip")
    change(args)
    with pytest.raises(ValueError, match=match):
        check_kernel_args(**args, dilations=TEACHER_DILATIONS,
                          kernel_dims=TRAIN_KERNEL_DIMS)


def test_train_backward_argument_checks():
    args = _teacher_shaped()
    acts = args["x0"][None].expand(24, -1, -1, -1).contiguous()
    bargs = dict(acts=acts, cond=args["cond"], w_in=args["w_in"],
                 b_g=args["b_g"], w_out=args["w_out"], dskip=args["dskip"])
    with pytest.raises(ValueError, match="CUDA device"):
        check_train_backward_args(**bargs, dilations=TEACHER_DILATIONS)
    with pytest.raises(ValueError, match="acts must be"):
        check_train_backward_args(**dict(bargs, acts=acts[:3]),
                                  dilations=TEACHER_DILATIONS)
    with pytest.raises(ValueError, match="dskip must be"):
        check_train_backward_args(**dict(bargs, dskip=args["dskip"][:1]),
                                  dilations=TEACHER_DILATIONS)
    with pytest.raises(ValueError, match="dilations"):
        check_train_backward_args(**bargs, dilations=TEACHER_DILATIONS[:-1])


# ------------------------------------------------------------- CUDA only


def _row_rel(out, ref):
    n = out.shape[0]
    err = (out.float() - ref.float()).abs().reshape(n, -1).amax(1)
    return err / (ref.float().abs().reshape(n, -1).amax(1) + 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", TRAIN_KERNEL_DIMS)
@pytest.mark.parametrize("B,T", [(2, 300), (1, 1), (3, 1000)])
def test_train_kernels_match_plain_on_card(cuda, B, T, dims):
    """bf16 kernels vs the plain versions in fp32 on the same bf16
    operands, in chip_smoke.py's input distribution and with its bound:
    forward skip per row within 0.02 (0.007-0.010 on the H100 at teacher_lj
    widths), every gradient within 0.02 of its largest value (0.003-0.007),
    in both backward modes, at both widths (the student's dilations reach
    512, past T = 300)."""
    t = _teacher_shaped(B, T, device=cuda, dims=dims)
    dil = TRAIN_STACKS[dims]
    g0, b0 = gated_layer.launches, flow_stack_train_backward.launches
    skip, acts = flow_stack_train_forward(**_fwd(t), dilations=dil)
    ref_skip, _ = flow_stack_train_reference(
        **{k: v.float() for k, v in _fwd(t).items()}, dilations=dil)
    assert (_row_rel(skip, ref_skip) <= 0.02).all()
    bargs = (acts, t["cond"], t["w_in"], t["b_g"], t["w_out"], t["dskip"])
    for want in (True, False):
        got = flow_stack_train_backward(*bargs, dilations=dil,
                                        want_wgrads=want)
        ref = flow_stack_backward_reference(
            *(a.float() for a in bargs), dilations=dil, want_wgrads=want)
        torch.cuda.synchronize()
        for name, g, r in zip(GRADS, got, ref):
            assert _rel(g.float().cpu(), r.cpu()) <= 0.02, name
    assert gated_layer.launches == g0 + len(dil)
    assert flow_stack_train_backward.launches == b0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dims", TRAIN_KERNEL_DIMS)
@pytest.mark.parametrize("B,T,d", [(1, 1, 1), (3, 1003, 128), (1, 4097, 4097),
                                   (2, 64, 64), (3, 97, 5), (2, 1000, 512)])
def test_wgrad_gemm_matches_matmul_on_card(cuda, B, T, d, dims):
    """Kernel 3's weight-gradient GEMM (TMA boxes read by wgmma as MN-major
    operands) against torch.matmul in fp32 of the same bf16 operands, at
    odd shapes: rows not a multiple of the 64-row stage, rows with t < d
    (all of them where d >= T), B = 1 with T = 1.  Both sum exact bf16
    products in fp32 in another order: 1e-3 of the largest value (a wrong
    descriptor or tap is O(1)).  Two runs are bit-identical.  At both
    widths."""
    C, G, S, M = dims
    gen = torch.Generator(device=cuda).manual_seed(B * 7919 + T + d)

    def arr(*shape):
        return torch.randn(shape, generator=gen, device=cuda).bfloat16()

    x, cond, dg = arr(B, T, C), arr(B, T, M), arr(B, T, G)
    dout, z = arr(B, T, C + S), arr(B, T, G // 2)
    n0 = flow_stack_train_wgrads.launches
    got = flow_stack_train_wgrads(x, cond, dg, dout, z, d)
    again = flow_stack_train_wgrads(x, cond, dg, dout, z, d)
    want = flow_stack_wgrads_reference(x, cond, dg, dout, z, d)  # fp32 matmuls
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.cpu(), w.cpu()) <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert flow_stack_train_wgrads.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dims", TRAIN_KERNEL_DIMS)
def test_train_backward_is_deterministic_and_rows_isolated_on_card(cuda,
                                                                   dims):
    """Weight gradients come from per-block partials summed in a fixed
    order: two runs are bit-identical.  dx of row 0 does not move when
    row 1's cotangent does.  The dx-only mode gives the same dx and dcond
    bits as the mode with weight gradients."""
    t = _teacher_shaped(2, 700, device=cuda, dims=dims)
    dil = TRAIN_STACKS[dims]
    _, acts = flow_stack_train_forward(**_fwd(t), dilations=dil)
    bargs = [acts, t["cond"], t["w_in"], t["b_g"], t["w_out"], t["dskip"]]
    a = flow_stack_train_backward(*bargs, dilations=dil)
    b = flow_stack_train_backward(*bargs, dilations=dil)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    bargs[5] = bargs[5].clone()
    bargs[5][1] *= 2.0
    c = flow_stack_train_backward(*bargs, dilations=dil, want_wgrads=False)
    assert torch.equal(a[0][0], c[0][0]) and not torch.equal(a[0][1], c[0][1])
    bargs[5][1] /= 2.0
    e = flow_stack_train_backward(*bargs, dilations=dil, want_wgrads=False)
    assert torch.equal(a[0], e[0]) and torch.equal(a[1], e[1])


@pytest.mark.gpu
def test_train_kernels_refuse_other_widths_on_card(cuda):
    """A CUDA tensor that neither body takes raises: fp16 operands (the
    wgmma bodies take bf16, the general ones fp32 or bf16), and in the
    backward a width past the general body's shared memory (G = 1,026:
    its 32-row dz and dout / dg tiles)."""
    dil = (1, 2, 4)
    t = _torch(_inputs(6, T=64, dilations=dil, **SMALL), torch.float16,
               cuda)
    with pytest.raises(ValueError, match="no kernel body takes"):
        flow_stack_train_forward(**_fwd(t), dilations=dil)
    acts = t["x0"][None].expand(3, -1, -1, -1).contiguous()
    with pytest.raises(ValueError, match="no kernel body takes"):
        flow_stack_train_backward(acts, t["cond"], t["w_in"], t["b_g"],
                                  t["w_out"], t["dskip"], dilations=dil)
    wide = _torch(_inputs(6, B=1, T=8, C=16, M=8, G=1026, S=16,
                          dilations=dil), torch.float32, cuda)
    acts = wide["x0"][None].expand(3, -1, -1, -1).contiguous()
    with pytest.raises(ValueError, match="no kernel body takes"):
        flow_stack_train_backward(acts, wide["cond"], wide["w_in"],
                                  wide["b_g"], wide["w_out"], wide["dskip"],
                                  dilations=dil)
