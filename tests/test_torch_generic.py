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

import re
from pathlib import Path

import pytest
import torch

from pwn_tpu_torch.ops import flow_stack as fs
from pwn_tpu_torch.ops.flow_stack import (
    SMEM_PER_BLOCK, TRAIN_KERNEL_DIMS, check_generic_args,
    check_generic_backward_args, flow_stack, flow_stack_backward_reference,
    flow_stack_reference, flow_stack_train_backward,
    flow_stack_train_forward, flow_stack_train_reference, generic_limits,
    generic_smem_bytes, generic_tile_rows, kernel1_takes, kernel_body)
from pwn_tpu_torch.ops.gated_layer import (
    check_generic_accumulate_args, check_generic_layer_args, gated_layer,
    gated_layer_accumulate, gated_layer_accumulate_reference,
    gated_layer_reference)

F32, BF16 = torch.float32, torch.bfloat16
TINY = (64, 128, 64, 40)             # tiny_teacher's (C, G, S, M)
# student_iaf's, teacher_lj's and the wide teacher's
STUDENT, TEACHER, WIDE = TRAIN_KERNEL_DIMS
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
    (BF16, WIDE, False, "wgmma"), (BF16, WIDE, True, "wgmma"),
    (F32, WIDE, False, "generic"), (F32, WIDE, True, "generic"),
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
    (F32, (320, 1026, 16, 8), True, "shared memory"),
    (BF16, (256, 3200, 256, 80), False, "shared memory"),
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
    """The general bodies take the widths whose routed tile fits a block's
    shared memory.  A block's shared memory: 3 ring slots of 64 rows x (16
    fp32 + 16 bytes) and a 16 x 128 fp32 weight slice, and the resident
    fp32 tiles (z; dz and dout / dg; dz over dout at G/2 <= 64), each row
    of 64 their padded width + 4 floats (32-row tiles where 64 rows do not
    fit).  Every preset's widths fit both bodies, and so do the wide
    teacher's; only G/2 and C + S set the edge, walked on both sides."""
    slots = 3 * (64 * 80 + 16 * 128 * 4)
    assert generic_smem_bytes(*TEACHER) == slots + 64 * (128 + 4) * 4
    assert generic_smem_bytes(*TEACHER, backward=True) == \
        slots + 64 * (128 + 4 + 256 + 4) * 4
    # at G/2 <= 64 dz sits over dout: student_iaf's backward block
    assert generic_smem_bytes(*STUDENT, backward=True) == \
        slots + 64 * (128 + 4) * 4
    for dims in (TINY, STUDENT, TEACHER, WIDE_40, *JAX_SHAPES):
        assert generic_smem_bytes(*dims, backward=True) <= SMEM_PER_BLOCK
        assert generic_limits(F32, *dims, backward=True) is None
    # the wide teacher: 64-row tiles forward, 32-row tiles backward
    wide = (256, 512, 256, 80)
    assert generic_smem_bytes(*wide) == slots + 64 * (256 + 4) * 4
    slots32 = 3 * (32 * 80 + 16 * 128 * 4)
    assert generic_smem_bytes(*wide, backward=True) == \
        slots32 + 32 * (256 + 4 + 512 + 4) * 4
    for dt in (F32, BF16):
        assert generic_limits(dt, *wide) is None
        assert generic_limits(dt, *wide, backward=True) is None
    # the edge on both sides: z's G/2 forward; dz and dout / dg backward
    # (G, and C + S at G/2 <= 64, where dz sits over dout)
    assert generic_limits(F32, 1, 3104, 1, 1) is None
    assert "shared memory" in generic_limits(F32, 1, 3106, 1, 1)
    assert generic_limits(F32, 1, 1024, 1, 1, backward=True) is None
    assert "shared memory" in generic_limits(F32, 1, 1026, 1, 1,
                                             backward=True)
    assert generic_limits(F32, 1551, 2, 1, 1, backward=True) is None
    assert "shared memory" in generic_limits(F32, 1551, 2, 2, 1,
                                             backward=True)
    for dims, backward in (((1, 3104, 1, 1), False),
                           ((1, 1024, 1, 1), True),
                           ((1551, 2, 1, 1), True)):
        assert generic_smem_bytes(*dims, backward) <= SMEM_PER_BLOCK
        assert generic_tile_rows(*dims, backward) == 32
    # the 2C + M activation columns stream: C and M set no bound forward
    assert generic_limits(F32, 4000, 2, 1, 5000) is None


def _csrc_constants() -> dict:
    """The `constexpr int NAME = value;` lines of csrc/generic.cuh."""
    text = (Path(fs.__file__).parents[1] / "csrc" / "generic.cuh").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_generic_mirror_holds_the_sources_constants():
    """The Python mirror of the general bodies' tile (slice rows, chunk
    columns, ring slots, a block's shared memory, which bounds the widths)
    is the one csrc/generic.cuh states, and its route picks 64-row tiles at
    every preset's widths and 32-row tiles only where 64 rows do not
    fit."""
    c = _csrc_constants()
    assert "MAX_ROWS" not in c
    assert (c["BK"], c["NB"], c["STAGES"], c["SMEM_MAX"],
            c["FULL_SMS"]) == (
        fs.GENERIC_BK, fs.GENERIC_NB, fs.GENERIC_STAGES, SMEM_PER_BLOCK,
        fs.GENERIC_FULL_SMS)
    # the layer pass's register route: three blocks an SM once the tiles
    # fill three on each of 132 SMs (student_iaf's 8 x 44,032), else two
    # (the tiny teacher's 1 x 16,000)
    assert fs.generic_layer_blocks(16000, 64) == 2
    assert fs.generic_layer_blocks(8 * 44032, 64) == 3
    assert fs.generic_layer_blocks(395 * 64, 64) == 2
    assert fs.generic_layer_blocks(395 * 64 + 1, 64) == 3
    assert fs.generic_layer_blocks(395 * 64 + 1, 32) == 3
    for dims in (TINY, STUDENT, TEACHER, WIDE_40, *JAX_SHAPES):
        for backward in (False, True):
            assert fs.generic_tile_rows(*dims, backward=backward) == 64
    # the widest G/2 the limit takes: its z (and dz, dg) tiles need 32 rows
    assert fs.generic_tile_rows(1, 1638, 1, 1) == 32
    assert fs.generic_tile_rows(1, 546, 1, 1, backward=True) == 32
    assert fs.generic_tile_rows(300, 2, 1, 221) == 64
    for dims, backward in (((1, 1638, 1, 1), False), ((1, 546, 1, 1), True)):
        assert fs._generic_smem_at(64, *dims, backward) > SMEM_PER_BLOCK
        assert generic_smem_bytes(*dims, backward) == fs._generic_smem_at(
            32, *dims, backward) <= SMEM_PER_BLOCK


def _old_limit(C, G, S, M, backward):
    """The widths the general bodies took before their tiles streamed the
    activations: (2C + M + G/2 (+ max(C + S, G)) + 32) rows of 272 bytes
    within a block's 232,448 bytes."""
    rows = 2 * C + M + G // 2 + (max(C + S, G) if backward else 0)
    return C >= 1 and S >= 1 and M >= 1 and G >= 2 and G % 2 == 0 and \
        (rows + 32) * 272 <= SMEM_PER_BLOCK


def _edge_widths(backward):
    """(C, G, S, M) along the old limit's edge: for each (C, S, M) the
    widest even G it took, and a few below."""
    for C in (1, 2, 3, 5, 16, 33, 64, 128, 200, 300):
        for S in (1, 7, 64, 128, 301):
            for M in (1, 8, 40, 80, 221):
                G = 2
                while _old_limit(C, G + 2, S, M, backward):
                    G += 2
                for g in {G, G - 2, G - 30, 128, 256, 2}:
                    if g >= 2 and g % 2 == 0 and _old_limit(C, g, S, M,
                                                            backward):
                        yield (C, g, S, M)


@pytest.mark.parametrize("backward", [False, True])
def test_every_width_taken_before_is_still_taken(backward):
    """Every (dtype, widths) the general bodies took before is taken: each
    preset's widths in fp32, the tiny widths in bf16, the old limit's edge
    2C + M + G/2 = 822 forward and its backward counterpart, and a walk
    along that edge; at each, the routed tile fits a block."""
    cases = [(F32, d) for d in (TINY, STUDENT, TEACHER, WIDE_40,
                                *JAX_SHAPES)]
    cases += [(BF16, TINY), (BF16, WIDE_40), (BF16, JAX_SHAPES[0])]
    cases += [(F32, (300, 2, 1, 221)), (F32, (200, 2, 1, 220)),
              (F32, (1, 1638, 1, 1)), (F32, (1, 546, 1, 1))]
    walked = list(_edge_widths(backward))
    assert len(walked) > 1000
    cases += [(dt, d) for d in walked for dt in (F32, BF16)]
    n = 0
    for dt, dims in cases:
        if not _old_limit(*dims, backward):
            continue
        n += 1
        assert generic_limits(dt, *dims, backward=backward) is None, dims
        assert kernel_body(dt, *dims, backward=backward) in ("generic",
                                                             "wgmma")
        assert generic_smem_bytes(*dims, backward) <= SMEM_PER_BLOCK, dims
    assert n > 2000


def _unpack(packed: fs.GenericWeights, G: int, K: int, N: int):
    """w_in (G, K) and w_out (N, G/2) read back from each packed matrix
    by the layout GenericWeights states, and the packed matrices with those
    entries zeroed (which must then be all zero: the padding)."""
    GH = G // 2
    d = fs._pack_dims(K, G, N)
    # chunk-major to columns: (chunks, rows, width) -> (rows, chunks * width)
    packed = fs.GenericWeights(*(t.transpose(0, 1).reshape(t.shape[1], -1)
                                 for t in packed))
    h = torch.arange(GH)
    col = 128 * (h // 64) + h % 64            # tanh column of h in gate
    gate = packed.gate.clone()
    w_in_gate = torch.cat([gate[:K, col].T, gate[:K, col + 64].T])
    gate[:K, col] = 0
    gate[:K, col + 64] = 0
    out = packed.out.clone()
    w_out_out = out[:GH, :N].T.clone()
    out[:GH, :N] = 0
    dz = packed.dz.clone()
    w_out_dz = dz[:N, :GH].clone()
    dz[:N, :GH] = 0
    dcat = packed.dcat.clone()
    w_in_dcat = torch.cat([dcat[:GH, :K], dcat[d["GHp"]:d["GHp"] + GH, :K]])
    dcat[:GH, :K] = 0
    dcat[d["GHp"]:d["GHp"] + GH, :K] = 0
    return ((w_in_gate, w_in_dcat), (w_out_out, w_out_dz),
            (gate, out, dz, dcat))


@pytest.mark.parametrize("dims", [TINY, STUDENT, (5, 34, 3, 7),
                                  (16, 130, 48, 8)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_packed_weights_unpack_to_the_stacked_layout(dims, dtype):
    """`WaveNetStack.generic_weights()` holds `stacked()`'s w_in and w_out
    exactly (fp32 of the compute dtype) in every packed matrix, zero
    everywhere else; each layer's slice is that layer's `layer_weights()`
    matrices; and the shapes are the ones the kernels are built to read."""
    from pwn_tpu_torch.models.modules import WaveNetStack

    C, G, S, M = dims
    stack = WaveNetStack((1, 2, 4), C, G, S, 2, M, dtype=dtype)
    stack.reset_parameters(torch.Generator().manual_seed(7))
    with torch.no_grad():
        w_in, _, w_out, _ = stack.stacked()
        packed = stack.generic_weights()
        layers = stack.layer_weights()
    d = fs.generic_pack_dims(*dims)
    assert tuple(packed.gate.shape) == (3, d["Gc"], d["Kp"], 128)
    assert tuple(packed.out.shape) == (3, d["Nc"], d["GHp"], 128)
    assert tuple(packed.dz.shape) == (3, d["Gc"], d["Np"], 64)
    assert tuple(packed.dcat.shape) == (3, d["Kc"], 2 * d["GHp"], 128)
    for t in packed:
        assert t.dtype == F32 and t.is_contiguous()
    fs.generic_packed(w_in, w_out, packed)   # its own check passes
    for l in range(3):
        ins, outs, rest = _unpack(packed.layer(l), G, 2 * C + M, C + S)
        for got in ins:
            assert torch.equal(got, w_in[l].float())
            assert torch.equal(got, layers[l][0].float())
        for got in outs:
            assert torch.equal(got, w_out[l].float())
            assert torch.equal(got, layers[l][2].float())
        for t in rest:
            assert not t.any()
    one = fs.pack_generic(w_in[1], w_out[1])
    assert all(torch.equal(a, b) for a, b in zip(one, packed.layer(1)))


def test_packed_weights_cache_follows_an_optimizer_step():
    """The packed form is built once while grad is off and reused, and an
    in-place optimizer step (which bumps the parameters' versions) builds it
    anew from the stepped weights."""
    from pwn_tpu_torch.models.modules import WaveNetStack

    stack = WaveNetStack((1, 2), *TINY[:3], 2, TINY[3])
    stack.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        first = stack.generic_weights()
        assert stack.generic_weights() is first
    opt = torch.optim.SGD(stack.parameters(), lr=0.1)
    loss = sum((p * p).sum() for p in stack.layers[1].parameters())
    loss.backward()
    opt.step()
    with torch.no_grad():
        stepped = stack.generic_weights()
        w_in, _, w_out, _ = stack.stacked()
    assert stepped is not first
    assert not torch.equal(stepped.gate, first.gate)
    assert all(torch.equal(a, b) for a, b in
               zip(stepped, fs.pack_generic(w_in, w_out)))
    # under grad nothing is kept: each call packs the weights it sees
    assert stack.generic_weights() is not stack.generic_weights()


def test_generic_packed_refuses_a_stale_layout():
    """A packed form of other widths, of another layer count or not fp32 is
    refused before any launch."""
    w_in, w_out = torch.randn(2, 128, 168), torch.randn(2, 128, 64)
    good = fs.pack_generic(w_in, w_out)
    for bad in (fs.pack_generic(w_in[:1], w_out[:1]),
                fs.pack_generic(torch.randn(2, 130, 168),
                                torch.randn(2, 128, 65)),
                good._replace(out=good.out.double())):
        with pytest.raises(ValueError, match="packed"):
            fs.generic_packed(w_in, w_out, bad)
    assert fs.generic_packed(w_in, w_out, good) is good


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
    (lambda a: a.update(w_in=torch.zeros(3200, 168),
                        w_out=torch.zeros(128, 1600)),
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


# The tiles' edges: C, S, M not multiples of 4 (the element-wise loads and
# stores), K = 2C + M not a multiple of the 16-row slice, G/2 not a multiple
# of the 64-column gate chunk (17, and 65: a second chunk of one column), a
# dilation past the 64-row tile, the widest rows the limit takes (822:
# 5 dcat chunks of K = 620; G = 546 backward and 1,638 forward on 32-row
# tiles), at B x T = 1 x 1, 3 x 127 (R not a multiple of the tile) and
# 2 x 257.  FWD_ONLY are past the backward's limit.
EDGE_CASES = [
    ((5, 34, 3, 7), F32, (1, 100)), ((5, 34, 3, 7), BF16, (1, 100)),
    ((16, 130, 48, 8), F32, (3, 512)), ((16, 130, 48, 8), BF16, (3, 512)),
    ((200, 2, 1, 220), F32, (2, 70)), ((1, 546, 1, 1), F32, (1, 65)),
    ((1, 546, 1, 1), BF16, (1, 65)),
]
FWD_ONLY = [((300, 2, 1, 221), F32, (1, 64)), ((1, 1638, 1, 1), F32, (1, 33)),
            ((1, 1638, 1, 1), BF16, (2,))]
EDGE_SHAPES = [(1, 1), (3, 127), (2, 257)]


@pytest.mark.gpu
@pytest.mark.parametrize("dims,dtype,dil", EDGE_CASES + FWD_ONLY)
@pytest.mark.parametrize("B,T", EDGE_SHAPES)
def test_generic_edges_match_plain_on_card(cuda, dims, dtype, dil, B, T):
    """At the tiles' edges both general bodies against their plain versions
    on the same card operands: kernel 2's route (skip and the saved inputs
    per row), kernel 5's "layer" epilogue per row, and where the backward
    takes the widths kernel 3 in both modes (dx per row, dcond and each
    weight gradient per tensor), two runs bit-identical (the split-K weight
    gradients too) and dx, dcond the same bits in both modes."""
    a = _stack_ops(dims, dtype, dil, B, T, device=cuda)
    dskip = a.pop("dskip")
    skip, acts = flow_stack_train_forward(**a, dilations=dil)
    ref_skip, ref_acts = flow_stack_train_reference(**a, dilations=dil)
    assert (_row_rel(skip, ref_skip) <= TOL[dtype]).all()
    assert (_row_rel(acts.transpose(0, 1), ref_acts.transpose(0, 1))
            <= TOL_ACTS[dtype]).all()
    top = [a[k][-1] for k in ("w_in", "b_g", "w_out", "b_rs")]
    with torch.inference_mode():
        got = gated_layer(a["x0"], a["cond"], *top, dil[-1])
        want = gated_layer_reference(a["x0"], a["cond"], *top, dil[-1])
    for g, w in zip(got, want):
        assert (_row_rel(g, w) <= TOL[dtype]).all()
    if (dims, dtype, dil) in FWD_ONLY:
        return
    bargs = (acts, a["cond"], a["w_in"], a["b_g"], a["w_out"], dskip)
    runs = {}
    for want_w in (True, False):
        got = flow_stack_train_backward(*bargs, dilations=dil,
                                        want_wgrads=want_w)
        ref = flow_stack_backward_reference(*bargs, dilations=dil,
                                            want_wgrads=want_w)
        assert (_row_rel(got[0], ref[0]) <= TOL[dtype]).all()
        for name, g, r in zip(GRADS, got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape, name
            assert float(_row_rel(g[None], r[None])[0]) <= TOL[dtype], name
        runs[want_w] = got
    again = flow_stack_train_backward(*bargs, dilations=dil)
    assert all(torch.equal(x, y) for x, y in zip(runs[True], again))
    assert torch.equal(runs[True][0], runs[False][0])
    assert torch.equal(runs[True][1], runs[False][1])


def test_generic_wgrad_operands_are_the_stored_layout():
    """The weight-gradient product's operands as the layer pass stores
    them: fp32, dg's tanh and sigmoid halves each padded to GHp columns,
    dout to Np, z to GHp, zero in the padding; on CPU tensors the entry
    point is the plain version."""
    gen = torch.Generator().manual_seed(5)
    B, T, (C, G, S, M) = 2, 9, (5, 34, 3, 7)
    dg, dout, z = (torch.randn((B, T, n), generator=gen)
                   for n in (G, C + S, G // 2))
    d = fs.generic_pack_dims(C, G, S, M)
    sdg, sdout, sz = fs.generic_wgrad_operands(dg.bfloat16(), dout, z)
    assert sdg.shape == (B, T, 2 * d["GHp"]) and sdg.dtype == F32
    assert torch.equal(sdg[..., :17], dg.bfloat16()[..., :17].float())
    assert torch.equal(sdg[..., 32:49], dg.bfloat16()[..., 17:].float())
    assert not sdg[..., 17:32].any() and not sdg[..., 49:].any()
    assert torch.equal(sdout[..., :8], dout) and not sdout[..., 8:].any()
    assert torch.equal(sz[..., :17], z) and not sz[..., 17:].any()
    x, cond = torch.randn(B, T, C), torch.randn(B, T, M)
    got = fs.flow_stack_train_wgrads_generic(x, cond, dg, dout, z, 3)
    want = fs.flow_stack_wgrads_reference(x, cond, dg, dout, z, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dims,dtype,B,T,d", [
    (TINY, F32, 1, 16000, 16), (TINY, BF16, 2, 1003, 512),
    (STUDENT, F32, 3, 127, 1), ((5, 34, 3, 7), F32, 2, 257, 100),
    ((16, 130, 48, 8), BF16, 1, 1, 3), ((1, 546, 1, 1), F32, 2, 33, 65),
])
def test_generic_wgrad_product_matches_plain_on_card(cuda, dims, dtype, B,
                                                     T, d):
    """Kernel 3's general weight-gradient product alone against its plain
    version on the same card operands (per tensor, at the fp32 gate: both
    sum the same fp32 products), and two runs bit-identical: the split-K
    partials are summed in split order, with no atomics."""
    C, G, S, M = dims
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((B, T, C), generator=gen, device=cuda).to(dtype)
    cond = torch.randn((B, T, M), generator=gen, device=cuda).to(dtype)
    dg, dout, z = (torch.randn((B, T, n), generator=gen, device=cuda)
                   .to(dtype).float() for n in (G, C + S, G // 2))
    n0 = fs.flow_stack_train_wgrads_generic.launches
    got = fs.flow_stack_train_wgrads_generic(x, cond, dg, dout, z, d)
    again = fs.flow_stack_train_wgrads_generic(x, cond, dg, dout, z, d)
    want = fs.flow_stack_wgrads_reference(x, cond, dg, dout, z, d)
    for g, a, w in zip(got, again, want):
        assert g.dtype == F32 and g.shape == w.shape
        assert float(_row_rel(g[None], w[None])[0]) <= TOL[F32]
        assert torch.equal(g, a)
    assert fs.flow_stack_train_wgrads_generic.launches == n0 + 2
