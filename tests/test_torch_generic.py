"""The general-width bodies of kernels 5 and 3 (`csrc/gated_layer_generic.cu`,
`csrc/flow_stack_train_generic.cu`): the route that picks a body from the
operand dtype and the widths (`ops/flow_stack.py::kernel_body`), the
general bodies' limits and argument checks, kernel 1's dtype rule, and — on
a CUDA card only — both general bodies against their plain versions per
batch row, in fp32 and bf16, at the presets' widths and the JAX kernel
tests' shapes, their determinism, and the launch counters that tell the
bodies apart.

The plain versions at tiny_teacher's widths are held against the JAX
Pallas kernels in tests/test_torch_gated_layer.py and
tests/test_torch_flow_stack_train.py.  This file imports no JAX, so the
CUDA cases also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_generic.py
"""

import pytest
import torch

from pwn_tpu_torch.ops import flow_stack as fs
from pwn_tpu_torch.ops.flow_stack import (
    SMEM_PER_BLOCK, TRAIN_KERNEL_DIMS, check_generic_args,
    check_generic_backward_args, flow_stack, flow_stack_backward_reference,
    flow_stack_reference, flow_stack_train_backward,
    flow_stack_train_forward, flow_stack_train_reference, generic_limits,
    generic_smem_bytes, kernel1_takes, kernel_body)
from pwn_tpu_torch.ops.gated_layer import (
    check_generic_accumulate_args, check_generic_layer_args, gated_layer,
    gated_layer_accumulate, gated_layer_accumulate_reference,
    gated_layer_reference)

F32, BF16 = torch.float32, torch.bfloat16
TINY = (64, 128, 64, 40)             # tiny_teacher's (C, G, S, M)
STUDENT, TEACHER = TRAIN_KERNEL_DIMS  # student_iaf's, teacher_lj's
WIDE_40 = (128, 256, 128, 40)
JAX_SHAPES = ((32, 64, 48, 16), (16, 32, 16, 8))  # the JAX kernel tests'
TINY_TEACHER_DIL = (1, 2, 4, 8, 16) * 2
TINY_FLOW_DIL = tuple(2 ** i for i in range(10))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,dims,backward,want", [
    (BF16, STUDENT, False, "wgmma"), (BF16, TEACHER, False, "wgmma"),
    (BF16, STUDENT, True, "wgmma"), (BF16, TEACHER, True, "wgmma"),
    (F32, STUDENT, False, "generic"), (F32, TEACHER, False, "generic"),
    (F32, STUDENT, True, "generic"), (F32, TEACHER, True, "generic"),
    (F32, TINY, False, "generic"), (F32, TINY, True, "generic"),
    (F32, WIDE_40, True, "generic"),
    (BF16, TINY, False, "generic"), (BF16, TINY, True, "generic"),
    (F32, JAX_SHAPES[0], True, "generic"),
    (BF16, JAX_SHAPES[1], True, "generic"),
])
def test_kernel_body_routes(dtype, dims, backward, want):
    """bf16 at the wgmma bodies' widths goes to them; fp32 at every
    preset's widths, and bf16 at a width they are not built for (40 mel
    bands, the JAX tests' shapes), to the general bodies."""
    assert kernel_body(dtype, *dims, backward=backward) == want


def test_kernel_body_is_the_same_for_cpu_and_card_tensors():
    """The route reads the dtype, which a tensor has on every device: the
    CPU's answer is the card's."""
    for dt in (F32, BF16):
        cpu, meta = torch.empty(0, dtype=dt), torch.empty(0, dtype=dt,
                                                          device="meta")
        for dims in (TINY, STUDENT, TEACHER):
            assert (kernel_body(cpu.dtype, *dims)
                    == kernel_body(meta.dtype, *dims))


@pytest.mark.parametrize("dtype,dims,backward,match", [
    (torch.float16, STUDENT, False, "float32 or bfloat16"),
    (torch.float64, TINY, True, "float32 or bfloat16"),
    (F32, (64, 127, 64, 40), False, "even G"),
    (F32, (0, 128, 64, 40), False, "C, S, M >= 1"),
    (F32, (320, 32, 16, 8), True, "shared memory"),
    (BF16, (256, 512, 256, 80), False, "shared memory"),
])
def test_kernel_body_refuses_what_neither_body_takes(dtype, dims, backward,
                                                     match):
    """A dtype or width neither body takes raises ValueError naming the
    wgmma bodies' widths and the general bodies' limit it broke."""
    with pytest.raises(ValueError, match="no kernel body takes") as e:
        kernel_body(dtype, *dims, backward=backward)
    assert match in str(e.value) and "wgmma bodies take bfloat16" in str(
        e.value)


def test_generic_limits_are_the_shared_memory_formula():
    """The general bodies' limit is a block's shared memory: 64-row tiles
    of fp32 rows (68 floats), 2C + M + G/2 of them (+ max(C + S, G) in the
    backward) plus a 32-row weight slice: 2C + M + G/2 (+ ...) <= 822.
    Every preset's widths fit both bodies."""
    assert generic_smem_bytes(*TEACHER) == (336 + 128 + 32) * 272
    assert generic_smem_bytes(*TEACHER, backward=True) == \
        (336 + 128 + 256 + 32) * 272
    for dims in (TINY, STUDENT, TEACHER, WIDE_40, *JAX_SHAPES):
        assert generic_smem_bytes(*dims, backward=True) <= SMEM_PER_BLOCK
        assert generic_limits(F32, *dims, backward=True) is None
    # the edge: 822 rows fit, 823 do not
    assert generic_limits(F32, 300, 2, 1, 221) is None     # 822 forward
    assert generic_limits(F32, 300, 2, 1, 222) is not None  # 823
    assert generic_limits(F32, 200, 2, 1, 220, backward=True) is None
    assert generic_limits(F32, 200, 2, 1, 221, backward=True) is not None


@pytest.mark.parametrize("dims,dtype,want", [
    (STUDENT, BF16, True), (STUDENT, F32, False), (TINY, F32, False),
    (TINY, BF16, False), (TEACHER, F32, False),
])
def test_kernel1_takes_only_bf16(dims, dtype, want):
    """Kernel 1 is bf16 only: an fp32 stack at its widths goes to kernel
    5's accumulate loop (the general body); bf16 stays on kernel 1."""
    assert kernel1_takes(TINY_FLOW_DIL, *dims, dtype) is want


def _layer_ops(dims, dtype, B=2, T=64, seed=0, device="cpu"):
    """x, cond and one layer's packed operands in `gated_layer`'s layout,
    biases fp32, in chip_smoke.py's distribution (unit-variance gate
    pre-activations)."""
    C, G, S, M = dims
    gen = torch.Generator().manual_seed(seed)

    def arr(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=gen) * scale).to(dt).to(device)

    return dict(x=arr((B, T, C), 0.5), cond=arr((B, T, M), 0.5),
                w_in=arr((G, 2 * C + M), (2 * C + M) ** -0.5),
                b_g=arr((G,), 0.1, F32),
                w_out=arr((C + S, G // 2), (G // 2) ** -0.5),
                b_out=arr((C + S,), 0.1, F32))


@pytest.mark.parametrize("change,match", [
    (lambda a: a.update(x=a["x"].half(), cond=a["cond"].half()),
     "float32 or bfloat16"),
    (lambda a: a.update(w_in=a["w_in"].bfloat16()), "w_in must be float32"),
    (lambda a: a.update(b_g=a["b_g"].bfloat16()), "b_g must be float32"),
    (lambda a: a.update(cond=a["cond"][:, :10]), "cond must be"),
    (lambda a: a.update(w_out=a["w_out"][:, :32]), "w_out must be"),
    (lambda a: a.update(x=torch.zeros(2, 64, 400), w_in=torch.zeros(
        128, 840), w_out=torch.zeros(464, 64), b_out=torch.zeros(464)),
     "shared memory"),
    (lambda a: None, "CUDA device"),
])
def test_generic_layer_argument_checks(change, match):
    """What kernel 5's general body does not take raises before any
    launch, its limits and dtypes before the device: a CPU tensor that
    reaches the kernel path is refused, never computed."""
    args = _layer_ops(TINY, F32)
    change(args)
    with pytest.raises(ValueError, match=match):
        check_generic_layer_args(**args, dilation=3)


def test_generic_accumulate_argument_checks():
    """The accumulate epilogue's buffers first, then the layer as the
    general body's check: every operand in x's dtype."""
    args = _layer_ops(TINY, BF16)
    args["b_rs"] = args.pop("b_out")
    acc = torch.zeros(2, 64, 64)
    out = torch.empty(2, 64, 64, dtype=BF16)
    with pytest.raises(ValueError, match="skip_acc must be"):
        check_generic_accumulate_args(**args, dilation=1, skip_acc=None,
                                      out=out, first=False, last=False)
    with pytest.raises(ValueError, match="cond must be float32"):
        check_generic_accumulate_args(
            **dict(args, x=args["x"].float()), dilation=1, skip_acc=acc,
            out=out.float(), first=False, last=False)
    with pytest.raises(ValueError, match="CUDA device"):
        check_generic_accumulate_args(**args, dilation=1, skip_acc=acc,
                                      out=out, first=False, last=False)


def _stack_ops(dims, dtype, dilations, B=2, T=64, seed=1, device="cpu"):
    """Stacked operands in `flow_stack`'s layout and a skip cotangent."""
    C, G, S, M = dims
    L = len(dilations)
    gen = torch.Generator().manual_seed(seed)

    def arr(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=gen) * scale).to(dt).to(device)

    return dict(x0=arr((B, T, C), 0.5), cond=arr((B, T, M), 0.5),
                w_in=arr((L, G, 2 * C + M), (2 * C + M) ** -0.5),
                b_g=arr((L, G), 0.1).float(),
                w_out=arr((L, C + S, G // 2), (G // 2) ** -0.5),
                b_rs=arr((L, C + S), 0.1).float(),
                dskip=arr((B, T, S), 1.0))


def test_generic_stack_argument_checks():
    """The general bodies' stack checks (kernel 2's forward and kernel 3's
    backward): dtype, limits, shapes and dilations before the device."""
    dil = (1, 2, 4)
    a = _stack_ops(TINY, F32, dil)
    dskip = a.pop("dskip")
    with pytest.raises(ValueError, match="CUDA device"):
        check_generic_args(**a, dilations=dil)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        check_generic_args(**dict(a, x0=a["x0"].half()), dilations=dil)
    with pytest.raises(ValueError, match="dilations"):
        check_generic_args(**a, dilations=dil[:2])
    acts = a["x0"][None].expand(3, -1, -1, -1).contiguous()
    bargs = dict(acts=acts, cond=a["cond"], w_in=a["w_in"], b_g=a["b_g"],
                 w_out=a["w_out"], dskip=dskip)
    with pytest.raises(ValueError, match="CUDA device"):
        check_generic_backward_args(**bargs, dilations=dil)
    with pytest.raises(ValueError, match="dskip must be"):
        check_generic_backward_args(**dict(bargs, dskip=dskip[:1]),
                                    dilations=dil)
    with pytest.raises(ValueError, match="acts must be"):
        check_generic_backward_args(**dict(bargs, acts=acts[0]),
                                    dilations=dil)
    with pytest.raises(ValueError, match="cond must be bfloat16"):
        check_generic_backward_args(
            **dict(bargs, acts=acts.bfloat16(), w_in=a["w_in"].bfloat16(),
                   w_out=a["w_out"].bfloat16(), dskip=dskip.bfloat16()),
            dilations=dil)


# ------------------------------------------------------------- CUDA only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda()   # TF32 off: the plain versions are true fp32


# Kernel vs its plain version on the same card operands, per batch row:
# max|diff| / max|ref|.  fp32: both sum exact fp32 products in fp32 in
# another order and take libm's gates, so 1e-4 of the row's scale (a wrong
# tap, row or column is O(1)).  bf16: the general body rounds z, out, x,
# dout and dg at the plain version's points; a flipped bf16 rounding,
# carried by later layers, stays within chip_smoke.py's bf16 gates (0.02,
# and 0.04 for the saved layer inputs, where an early flip is carried).
TOL = {F32: 1e-4, BF16: 0.02}
TOL_ACTS = {F32: 1e-4, BF16: 0.04}
SHAPES = [(1, 1), (3, 127), (2, 1003)]


def _row_rel(out, ref):
    n = out.shape[0]
    err = (out.float() - ref.float()).abs().reshape(n, -1).amax(1)
    return err / (ref.float().abs().reshape(n, -1).amax(1) + 1e-12)


def _by(epilogue):
    return {k: v for k, v in gated_layer.launches_by.items()
            if k[1] == epilogue}


@pytest.mark.gpu
@pytest.mark.parametrize("dims,dtype", [
    (TINY, F32), (STUDENT, F32), (TEACHER, F32), (TINY, BF16),
    (JAX_SHAPES[0], F32), (JAX_SHAPES[0], BF16), (JAX_SHAPES[1], F32),
    (JAX_SHAPES[1], BF16),
])
@pytest.mark.parametrize("B,T", SHAPES)
def test_generic_layer_matches_plain_on_card(cuda, dims, dtype, B, T):
    """Kernel 5's general body in both epilogues against the plain version
    on the same card operands, per batch row, at d = 1, 16 and 512 (past
    T for the short shapes): "layer" res and skip; "accumulate" as the
    first, a middle and the last layer of a chain, skip_acc checked after
    the middle one.  Every launch counts as ("generic", epilogue)."""
    before = gated_layer.launches_by.copy()
    for d in (1, 16, 512):
        a = _layer_ops(dims, dtype, B, T, seed=d, device=cuda)
        with torch.inference_mode():
            got = gated_layer(*a.values(), d)
            want = gated_layer_reference(*a.values(), d)
            for g, w in zip(got, want):
                assert g.dtype == dtype and g.shape == w.shape
                assert (_row_rel(g, w) <= TOL[dtype]).all(), (d, g.shape)
            C, S = dims[0], dims[2]
            acc = torch.empty((B, T, S), device=cuda)
            acc_ref = torch.empty_like(acc)
            x = a["x"]
            for first, last in ((True, False), (False, False),
                                (False, True)):
                ops = (x, *list(a.values())[1:], d)
                got = gated_layer_accumulate(*ops, acc, first=first,
                                             last=last)
                want = gated_layer_accumulate_reference(
                    *ops, acc_ref, first=first, last=last)
                assert (_row_rel(got, want) <= TOL[dtype]).all(), (d, first)
                if not last:
                    assert (_row_rel(acc, acc_ref) <= TOL[dtype]).all()
                    x = got
    torch.cuda.synchronize()
    after = gated_layer.launches_by
    assert after[("generic", "layer")] == before[("generic", "layer")] + 3
    assert after[("generic", "accumulate")] == \
        before[("generic", "accumulate")] + 9
    assert after[("wgmma", "layer")] == before[("wgmma", "layer")]


GRADS = ("dx", "dcond", "dw_in", "db_g", "dw_out", "db_rs")


@pytest.mark.gpu
@pytest.mark.parametrize("dims,dtype,dil", [
    (TINY, F32, TINY_TEACHER_DIL), (TINY, F32, TINY_FLOW_DIL),
    (TINY, BF16, TINY_TEACHER_DIL), (TINY, BF16, TINY_FLOW_DIL),
    (STUDENT, F32, TINY_FLOW_DIL), (TEACHER, F32, TINY_TEACHER_DIL),
    (JAX_SHAPES[0], F32, (1, 4, 64)), (JAX_SHAPES[0], BF16, (1, 4, 64)),
    (JAX_SHAPES[1], F32, (1, 512)), (JAX_SHAPES[1], BF16, (1, 512)),
])
@pytest.mark.parametrize("B,T", SHAPES)
def test_generic_train_matches_plain_on_card(cuda, dims, dtype, dil, B, T):
    """Kernel 2's route (the general accumulate body once per layer) and
    kernel 3's general body in both modes against the plain versions on
    the same card operands: skip and every layer's saved input per batch
    row, dx per batch row, dcond and each weight gradient per tensor (of
    its largest value).  The tiny teacher's stack (dilations 1..16), the
    tiny student's flow (1..512), both preset widths in fp32, the JAX
    tests' shapes.  The wgmma bodies stay at 0 launches."""
    a = _stack_ops(dims, dtype, dil, B, T, device=cuda)
    dskip = a.pop("dskip")
    g0 = gated_layer.launches_by.copy()
    b0 = flow_stack_train_backward.launches_by.copy()
    skip, acts = flow_stack_train_forward(**a, dilations=dil)
    ref_skip, ref_acts = flow_stack_train_reference(**a, dilations=dil)
    assert (_row_rel(skip, ref_skip) <= TOL[dtype]).all()
    assert (_row_rel(acts.transpose(0, 1), ref_acts.transpose(0, 1))
            <= TOL_ACTS[dtype]).all()
    bargs = (acts, a["cond"], a["w_in"], a["b_g"], a["w_out"], dskip)
    for want in (True, False):
        got = flow_stack_train_backward(*bargs, dilations=dil,
                                        want_wgrads=want)
        ref = flow_stack_backward_reference(*bargs, dilations=dil,
                                            want_wgrads=want)
        assert len(got) == len(ref) == (6 if want else 2)
        assert (_row_rel(got[0], ref[0]) <= TOL[dtype]).all()
        for name, g, r in zip(GRADS, got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape, name
            assert float(_row_rel(g[None], r[None])[0]) <= TOL[dtype], name
    torch.cuda.synchronize()
    C = dims[0]
    after = flow_stack_train_backward.launches_by
    for want in (True, False):
        key = ("generic", C, want)
        assert after[key] == b0[key] + 1
        assert after[(C, want)] == b0[(C, want)]
    assert gated_layer.launches_by[("generic", "accumulate")] == \
        g0[("generic", "accumulate")] + len(dil)


@pytest.mark.gpu
@pytest.mark.parametrize("dims,dtype", [(TINY, F32), (TINY, BF16),
                                        (TEACHER, F32)])
def test_generic_backward_is_deterministic_on_card(cuda, dims, dtype):
    """No atomics: two runs are bit-identical; the dx-only mode gives the
    same dx and dcond bits; dx of row 0 does not move when row 1's
    cotangent does."""
    dil = TINY_FLOW_DIL
    a = _stack_ops(dims, dtype, dil, 2, 1003, device=cuda)
    dskip = a.pop("dskip")
    _, acts = flow_stack_train_forward(**a, dilations=dil)
    bargs = [acts, a["cond"], a["w_in"], a["b_g"], a["w_out"], dskip]
    one = flow_stack_train_backward(*bargs, dilations=dil)
    two = flow_stack_train_backward(*bargs, dilations=dil)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    dx_only = flow_stack_train_backward(*bargs, dilations=dil,
                                        want_wgrads=False)
    assert torch.equal(one[0], dx_only[0]) and torch.equal(one[1],
                                                           dx_only[1])
    bargs[5] = dskip.clone()
    bargs[5][1] *= 2.0
    moved = flow_stack_train_backward(*bargs, dilations=dil,
                                      want_wgrads=False)
    assert torch.equal(one[0][0], moved[0][0])
    assert not torch.equal(one[0][1], moved[0][1])


@pytest.mark.gpu
def test_fp32_inference_stack_runs_the_generic_chain_on_card(cuda):
    """An fp32 stack at kernel 1's own widths is not kernel 1's: `flow_stack`
    runs the general accumulate body once per layer (kernel 1 and the
    wgmma body at 0), within 1e-4 per row of the plain version; the same
    stack in bf16 stays on kernel 1."""
    dil = TINY_FLOW_DIL
    a = _stack_ops(STUDENT, F32, dil, 2, 1003, device=cuda)
    a.pop("dskip")
    k1 = fs.flow_stack.launches
    by = gated_layer.launches_by.copy()
    with torch.inference_mode():
        got = flow_stack(**a, dilations=dil)
        want = flow_stack_reference(**a, dilations=dil)
        bf = flow_stack(**{k: (v if k in ("b_g", "b_rs") else v.bfloat16())
                           for k, v in a.items()}, dilations=dil)
    torch.cuda.synchronize()
    assert (_row_rel(got, want) <= TOL[F32]).all()
    assert bf.dtype == BF16
    assert fs.flow_stack.launches == k1 + 1
    assert gated_layer.launches_by[("generic", "accumulate")] == \
        by[("generic", "accumulate")] + len(dil)
    assert gated_layer.launches_by[("wgmma", "accumulate")] == \
        by[("wgmma", "accumulate")]
