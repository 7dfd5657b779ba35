"""Whole-stack WaveNet flow: plain PyTorch versions and the wrappers of the
CUDA kernels (counterpart of `pwn_tpu/ops/pallas/flow_stack.py`).

Inference (`fused_flow_stack`):  `flow_stack` -> `csrc/flow_stack.cu`
(kernel 1, student widths in bf16), or elsewhere kernel 5's accumulate
epilogue once per layer (through `ops/gated_layer.py::
flow_stack_by_layers`).
Training (`fused_flow_stack_train` / `fused_flow_stack_score`):
`flow_stack_train` / `flow_stack_score`, a `torch.autograd.Function`
whose forward is `flow_stack_train_forward` (kernel 2, which also saves
every layer's input: kernel 5's accumulate epilogue once per layer,
through `ops/gated_layer.py::flow_stack_train_by_layers`) and whose
backward is `flow_stack_train_backward` (kernel 3, with or without the
weight gradients; its weight-gradient GEMM alone, bf16 at the wgmma
widths, is `flow_stack_train_wgrads`).

Kernels 5 and 3 each have two CUDA bodies, and `kernel_body` picks one
from the operand dtype and the widths alone:
* "wgmma" (`csrc/gated_layer.cu`, `csrc/flow_stack_train.cu`): bf16 at
  student_iaf's, teacher_lj's and the wide teacher's widths
  (`TRAIN_KERNEL_DIMS`; the wide one on 64-row tiles whose columns the two
  consumer warpgroups split, `wgmma_smem_bytes`);
* "generic" (`csrc/gated_layer_generic.cu`,
  `csrc/flow_stack_train_generic.cu`): fp32 or bf16 at any other width
  within `generic_limits` (the 40-mel tiny configs, every preset run in
  fp32), products and gates in fp32 FMAs on the CUDA cores.
A dtype or width neither takes raises ValueError.

`flow_stack` takes the stacked layout of `WaveNetStack.stacked()`:
    x0    (B, T, C)        compute dtype, the front 1x1 output
    cond  (B, T, M)        compute dtype
    w_in  (L, G, 2C+M)     compute dtype, (out, in): input columns
                           [x | shift(x, d) | cond]
    b_g   (L, G)           float32
    w_out (L, C+S, G/2)    compute dtype, (out, in): output rows
                           [residual | skip]
    b_rs  (L, C+S)         float32
and returns the summed skip output (B, T, S) in the compute dtype.  The
weights are the JAX kernel's `(L, 2C+M, G)` and `(L, G/2, C+S)` transposed,
as `nn.Linear` stores them, which is also the K-major B operand kernel 1's
wgmma reads from its TMA-filled weight ring.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel
or raises.  There is no fallback between the two: the plain versions are
the CPU oracle of the tests and the on-card comparison of `chip_smoke.py`.

Rounding points, kept by the kernels and their plain versions alike:
forward as the Pallas kernel (GEMMs accumulate in fp32, bias and gates in
fp32, z and x rounded to the compute dtype every layer, skip summed in
fp32); backward as `_bwd_chunk_kernel` (dout = [dx | dskip] and dg rounded
to the compute dtype before their GEMMs, z rounded for dW_out, dz, the
gate derivatives and every sum in fp32).  Two roundings of the Pallas
backward come from the TPU's tiles and layer chunks and are not kept:
the tap cotangent and dx stay fp32 from layer to layer.  dx and dcond are
returned in the compute dtype, the weight gradients in fp32.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Sequence

import torch

from pwn_tpu_torch.ops.conv import shift_right

# the widths the inference kernel is compiled for (student_iaf): C, G, S, M
KERNEL_DIMS = (64, 128, 64, 80)
# the widths the training kernels (and kernel 5's wgmma body) are compiled
# for: student_iaf's, teacher_lj's and the JAX package's wide teacher's
TRAIN_KERNEL_DIMS = ((64, 128, 64, 80), (128, 256, 128, 80),
                     (256, 512, 256, 80))
# Shared memory a Hopper block may opt in to (H100 and H200), and kernel 1's
# use of it (csrc/flow_stack.cu, pwn_flow_stack_smem_bytes): 1 KB of
# alignment slack, a ring of three 16 KB weight stages, the 128-row x tile
# and the per-layer rings of sum(d) rows in 128-byte rows (C bf16), a
# 128-row cond tile of M + 8 bf16, and six 8-byte barriers.
SMEM_PER_BLOCK = 232_448
# The general bodies (csrc/generic.cuh): k-slices of GENERIC_BK rows,
# output chunks of GENERIC_NB columns, a ring of GENERIC_STAGES slots, row
# tiles of 64 or 32 (`generic_tile_rows`), and the widths they take: those
# whose routed tile fits SMEM_PER_BLOCK (`generic_limits`).
GENERIC_BK, GENERIC_NB, GENERIC_STAGES = 16, 128, 3
GENERIC_DTYPES = (torch.float32, torch.bfloat16)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pack_dims(K: int, G: int, N: int) -> dict:
    GH = G // 2
    return dict(K=K, GH=GH, N=N, Kp=_up(K, GENERIC_BK),
                GHp=_up(GH, GENERIC_BK), Np=_up(N, GENERIC_BK),
                Gc=-(-GH // 64), Nc=-(-N // GENERIC_NB),
                Kc=-(-K // GENERIC_NB))


def generic_pack_dims(C: int, G: int, S: int, M: int) -> dict:
    """The packed weights' dimensions (`gen::pack_dims`): K = 2C + M, GH =
    G/2, N = C + S, each padded to GENERIC_BK (Kp, GHp, Np), and the chunk
    counts Gc (64 tanh columns and their sigmoid partners), Nc (128 out
    columns), Kc (128 dcat columns)."""
    return _pack_dims(2 * C + M, G, C + S)


def _packed_shapes(K: int, G: int, N: int) -> dict:
    d = _pack_dims(K, G, N)
    return {"gate": (d["Gc"], d["Kp"], 128),
            "out": (d["Nc"], d["GHp"], GENERIC_NB),
            "dz": (d["Gc"], d["Np"], 64),
            "dcat": (d["Kc"], 2 * d["GHp"], GENERIC_NB)}


def _generic_smem_at(tm: int, C: int, G: int, S: int, M: int,
                     backward: bool) -> int:
    p = generic_pack_dims(C, G, S, M)
    stage = tm * (GENERIC_BK * 4 + 16) + GENERIC_BK * GENERIC_NB * 4
    cols = p["GHp"] + 4 if not backward or p["Gc"] > 1 else 0
    if backward:
        cols += max(p["Np"], 2 * p["GHp"]) + 4
    return GENERIC_STAGES * stage + tm * cols * 4


def generic_tile_rows(C: int, G: int, S: int, M: int,
                      backward: bool = False) -> int:
    """The general bodies' row tile at these widths (`gen::tile_rows`, a
    route of the widths alone): 64 rows, or 32 where a 64-row block's
    resident tiles do not fit SMEM_PER_BLOCK."""
    return (64 if _generic_smem_at(64, C, G, S, M, backward)
            <= SMEM_PER_BLOCK else 32)


# the SM count the layer pass's register route is sized for (an H100's)
GENERIC_FULL_SMS = 132


def generic_layer_blocks(R: int, tile_rows: int) -> int:
    """Blocks an SM kernel 3's general layer pass is built for at R rows of
    `tile_rows`-row tiles (`gen::layer_blocks`, a route of R and the tile
    alone): 3 where the tiles fill three blocks on each of an H100's 132
    SMs, else 2 (fewer blocks, more registers each)."""
    return 3 if -(-R // tile_rows) >= 3 * GENERIC_FULL_SMS else 2


def generic_smem_bytes(C: int, G: int, S: int, M: int,
                       backward: bool = False) -> int:
    """Shared memory of a general body's block at these widths, at the tile
    `generic_tile_rows` routes to (`gen::smem_bytes`): the ring's
    GENERIC_STAGES slots (the tile's rows of GENERIC_BK activations, 16
    bytes past each row, and a GENERIC_BK x 128 fp32 weight slice) and the
    resident fp32 tiles, each row 4 floats past its width: z forward;
    dout then dg, and where G/2 > 64 dz, backward (at G/2 <= 64 dz sits
    over dout)."""
    return _generic_smem_at(generic_tile_rows(C, G, S, M, backward), C, G,
                            S, M, backward)


def generic_limits(dtype, C: int, G: int, S: int, M: int,
                   backward: bool = False) -> str | None:
    """Why the general bodies (kernel 5's forward, or with `backward`
    kernel 3's) do not take this dtype and these widths, or None where they
    do (`gen::widths_ok`): float32 or bfloat16 operands; C, S, M >= 1; an
    even G >= 2; and a routed tile (`generic_tile_rows`) whose block fits
    SMEM_PER_BLOCK.  Only z (G/2 columns) and, backward, dout / dg and dz
    (C + S and G columns) stay resident; the 2C + M activation columns
    stream, so C and M set no bound of their own."""
    if dtype not in GENERIC_DTYPES:
        return f"the general bodies take float32 or bfloat16, got {dtype}"
    if min(C, S, M) < 1 or G < 2 or G % 2:
        return (f"the general bodies take C, S, M >= 1 and an even G >= 2, "
                f"got (C, G, S, M) = {(C, G, S, M)}")
    smem = generic_smem_bytes(C, G, S, M, backward)
    if smem > SMEM_PER_BLOCK:
        return (f"the general {'backward' if backward else 'forward'} "
                f"body's {generic_tile_rows(C, G, S, M, backward)}-row tile "
                f"needs {smem} bytes of shared memory at (C, G, S, M) = "
                f"{(C, G, S, M)}; a block has {SMEM_PER_BLOCK}")
    return None


class GenericWeights(NamedTuple):
    """A stack's weights packed for the general bodies (`pack_generic`),
    fp32, chunk-major and k-major within a chunk (so that 16 k-rows of a
    chunk are one contiguous run), zero past the real widths; per layer:
        gate (Gc, Kp, 128)    g = cat @ gate; chunk j's column c is tanh
                              column 64 j + c (c < 64), else its sigmoid
                              partner
        out  (Nc, GHp, 128)   out = z @ out
        dz   (Gc, Np, 64)     dz = dout @ dz
        dcat (Kc, 2*GHp, 128) dcat = dg @ dcat, dg's columns [tanh |
                              sigmoid], each padded to GHp
    with a leading layer axis for a stack, none for one layer."""
    gate: torch.Tensor
    out: torch.Tensor
    dz: torch.Tensor
    dcat: torch.Tensor

    def layer(self, l: int) -> "GenericWeights":
        return GenericWeights(*(t[l] for t in self))


def pack_generic(w_in: torch.Tensor, w_out: torch.Tensor) -> GenericWeights:
    """`GenericWeights` of w_in (L, G, 2C+M) and w_out (L, C+S, G/2) in the
    stacked (out, in) layout (or one layer's (G, 2C+M), (C+S, G/2)), on their
    device, without grad."""
    one = w_in.dim() == 2
    if one:
        w_in, w_out = w_in[None], w_out[None]
    L, G, K = w_in.shape
    N, GH = w_out.shape[1:]
    d = _pack_dims(K, G, N)
    Kp, GHp, Np, Gc = d["Kp"], d["GHp"], d["Np"], d["Gc"]
    pad = torch.nn.functional.pad
    with torch.no_grad():
        wi, wo = w_in.float(), w_out.float()
        tanh_sig = (wi[:, :GH], wi[:, GH:])
        gate = torch.cat([pad(h, (0, Kp - K, 0, 64 * Gc - GH))
                          .reshape(L, Gc, 1, 64, Kp) for h in tanh_sig], 2)
        out = pad(wo.transpose(1, 2),
                  (0, d["Nc"] * GENERIC_NB - N, 0, GHp - GH))
        dz = pad(wo, (0, 64 * Gc - GH, 0, Np - N))
        dcat = torch.cat([pad(h, (0, d["Kc"] * GENERIC_NB - K, 0, GHp - GH))
                          for h in tanh_sig], 1)
        packed = GenericWeights(   # columns split into chunks, chunk-major
            gate=gate.reshape(L, Gc, 128, Kp).transpose(2, 3),
            out=out.reshape(L, GHp, d["Nc"], 128).transpose(1, 2),
            dz=dz.reshape(L, Np, Gc, 64).transpose(1, 2),
            dcat=dcat.reshape(L, 2 * GHp, d["Kc"], 128).transpose(1, 2))
        packed = GenericWeights(*(t.contiguous() for t in packed))
    return packed.layer(0) if one else packed


def generic_packed(w_in, w_out, packed: GenericWeights | None = None):
    """`packed`, checked against w_in and w_out's widths, layers and device
    (ValueError), or `pack_generic(w_in, w_out)` where it is None."""
    if packed is None:
        return pack_generic(w_in, w_out)
    lead = tuple(w_in.shape[:-2])
    shapes = _packed_shapes(w_in.shape[-1], w_in.shape[-2], w_out.shape[-2])
    for name, t in packed._asdict().items():
        want = (*lead, *shapes[name])
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or t.device != w_in.device or not t.is_contiguous()):
            raise ValueError(f"packed.{name} must be a contiguous float32 "
                             f"{want} tensor on {w_in.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return packed


def kernel_body(dtype, C: int, G: int, S: int, M: int,
                backward: bool = False) -> str:
    """Which CUDA body a call of kernel 5 (the forward layer, also kernel
    2's route) or, with `backward`, kernel 3 reaches: "wgmma" for bf16 at
    the widths those bodies are built for (`TRAIN_KERNEL_DIMS`, kernel 5's
    too), "generic" for fp32 or bf16 within `generic_limits`.  Anything
    else raises ValueError naming both bodies' limits.  The dtype and the
    widths alone decide, so the answer is the same on the CPU and on the
    card; it is a route, never a fallback: a bf16 call at a built width
    never reaches the general body."""
    if dtype == torch.bfloat16 and (C, G, S, M) in TRAIN_KERNEL_DIMS:
        return "wgmma"
    why = generic_limits(dtype, C, G, S, M, backward)
    if why:
        raise ValueError(f"no kernel body takes {dtype} at (C, G, S, M) = "
                         f"{(C, G, S, M)}: the wgmma bodies take bfloat16 "
                         f"at {list(TRAIN_KERNEL_DIMS)}, and {why}")
    return "generic"


def wgmma_smem_bytes(C: int, G: int, S: int, M: int,
                     backward: bool = False) -> int:
    """Shared memory of a wgmma body's block at one of `TRAIN_KERNEL_DIMS`
    (a mirror of `csrc/gated_layer.cu`'s `Dims` / `SplitDims::SMEM`, or with
    `backward` of `csrc/flow_stack_train.cu`'s layer pass, `Lay` /
    `SplitDims::SMEM`): 64-column bf16 slices of the activation tiles (x,
    tap, cond; forward z, backward dout / dg) of 128 rows, or 64 at the
    wide widths; the weight ring (forward three stages of a k-slice of
    every gate or output row, or of one warpgroup's half at the wide
    widths; backward four 16 KB slots); the mbarriers; 1 KB of alignment
    slack."""
    if (C, G, S, M) not in TRAIN_KERNEL_DIMS:
        raise ValueError(f"no wgmma body at (C, G, S, M) = {(C, G, S, M)}")
    split = G > 256
    rows = 64 if split else 128
    slice_ = rows * 128
    xs, cs = C // 64, 2
    if backward:
        tiles = (2 * xs + cs + (C + S) // 64) * slice_
        return tiles + 4 * 16_384 + 8 * (12 if split else 14) + 1024
    tiles = (3 * xs + cs) * slice_
    stage = (G // 2 if split else max(G, C + S)) * 128
    stages = 3 if tiles + 3 * stage + 64 + 1024 <= SMEM_PER_BLOCK else 2
    # the barriers: the activations' pair, and per stage an empty barrier
    # and a full one (one per consumer warpgroup at the wide widths)
    return tiles + stages * stage + 8 * (2 + (3 if split else 2) * stages) + 1024


def _kernel1_smem_bytes(sum_d: int) -> int:
    C, _, _, M = KERNEL_DIMS
    stages, tile = 3, 128
    return (1024 + stages * 16_384 + (tile + sum_d) * C * 2
            + tile * (M + 8) * 2 + stages * 16)


def kernel1_takes(dilations: Sequence[int], C: int, G: int, S: int,
                  M: int, dtype=torch.bfloat16) -> bool:
    """Whether kernel 1 takes a stack of these widths, dilations and
    operand dtype: bf16 at its compiled widths, at most 32 layers, a
    largest dilation of at most 512 (the reference's one-tile bound) and
    rings that fit a block's shared memory.  It picks the kernel of an
    inference stack, not its rounding: where it does not hold, `flow_stack`
    runs kernel 5's accumulate loop.  Dtype, widths and dilations alone
    decide, so the answer is the same on the CPU and on the card."""
    return (dtype == torch.bfloat16 and (C, G, S, M) == KERNEL_DIMS
            and 1 <= len(dilations) <= 32
            and max(dilations) <= 512
            and _kernel1_smem_bytes(sum(dilations)) <= SMEM_PER_BLOCK)


def layer_out(x, cond, w_in, b, w_out, b_out, dilation: int) -> torch.Tensor:
    """One layer's out = z @ W_out + b_out in fp32, z = tanh(g[:G/2]) *
    sigmoid(g[G/2:]) rounded to x's dtype, g = [x | shift(x, d) | cond] @
    W_in + b: the arithmetic and rounding points every plain version here
    and in `ops/gated_layer.py` shares (operands in x's dtype, GEMM sums,
    biases and gates in fp32; the operands are exact in fp32)."""
    dt = x.dtype
    f32 = torch.float32
    cat = torch.cat([x, shift_right(x, dilation), cond.to(dt)], dim=-1)
    g = cat.to(f32) @ w_in.to(dt).to(f32).mT + b.to(f32)
    a, s = g.chunk(2, dim=-1)
    z = (torch.tanh(a) * torch.sigmoid(s)).to(dt)
    return z.to(f32) @ w_out.to(dt).to(f32).mT + b_out.to(f32)


def _stack_reference(x0, cond, w_in, b_g, w_out, b_rs,
                     dilations: Sequence[int], save_acts: bool):
    dt = x0.dtype
    C = x0.shape[-1]
    x = x0
    skip = torch.zeros(x0.shape[:-1] + (w_out.shape[1] - C,),
                       dtype=torch.float32, device=x0.device)
    acts = []
    for l, d in enumerate(dilations):
        if save_acts:
            acts.append(x)
        out = layer_out(x, cond, w_in[l], b_g[l], w_out[l], b_rs[l], d)
        x = x + out[..., :C].to(dt)
        skip = skip + out[..., C:]
    return skip.to(dt), (torch.stack(acts) if save_acts else None)


def flow_stack_reference(x0, cond, w_in, b_g, w_out, b_rs,
                         dilations: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch stack in the Pallas kernel's rounding order: GEMMs
    accumulate in fp32 (the operands are exact in fp32), bias and gates in
    fp32, z and x rounded to the compute dtype every layer, skip summed in
    fp32 and returned in the compute dtype."""
    return _stack_reference(x0, cond, w_in, b_g, w_out, b_rs, dilations,
                            save_acts=False)[0]


def flow_stack_train_reference(x0, cond, w_in, b_g, w_out, b_rs,
                               dilations: Sequence[int]):
    """`flow_stack_reference` that also returns every layer's input:
    (skip (B, T, S), acts (L, B, T, C)) in the compute dtype, acts[0] = x0
    (the plain version of `_fwd_save_kernel`)."""
    return _stack_reference(x0, cond, w_in, b_g, w_out, b_rs, dilations,
                            save_acts=True)


def _shift_left(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, t + d], zero past the end (the adjoint of `shift_right`)."""
    if d >= x.shape[1]:
        return torch.zeros_like(x)
    return torch.cat([x[:, d:], torch.zeros_like(x[:, :d])], dim=1)


def flow_stack_backward_reference(acts, cond, w_in, b_g, w_out, dskip,
                                  dilations: Sequence[int],
                                  want_wgrads: bool = True):
    """Plain version of `_bwd_chunk_kernel`'s math over the whole sequence
    (no tiles, no layer chunks), in the module docstring's rounding order.

    Returns (dx, dcond) in the compute dtype and, with `want_wgrads`, the
    fp32 (dw_in (L, G, 2C+M), db_g (L, G), dw_out (L, C+S, G/2),
    db_rs (L, C+S)) in the weights' (out, in) layout."""
    dt = acts.dtype
    f32 = torch.float32
    L, B, T, C = acts.shape
    M = cond.shape[-1]
    cond = cond.to(dt)
    dskip = dskip.to(dt)
    grads = []
    dx_part = dcs = None
    d_prev = 0
    dcond = torch.zeros((B, T, M), dtype=f32, device=acts.device)
    for l in range(L - 1, -1, -1):
        d = dilations[l]
        x = acts[l]
        cat = torch.cat([x, shift_right(x, d), cond], dim=-1).to(f32)
        w_in_l = w_in[l].to(dt).to(f32)                  # (G, 2C+M)
        g = cat @ w_in_l.mT + b_g[l].to(f32)
        a, b = g.chunk(2, dim=-1)
        ta, sb = torch.tanh(a), torch.sigmoid(b)
        if dx_part is None:   # the top layer's residual output is unused
            dx = torch.zeros((B, T, C), dtype=f32, device=acts.device)
        else:
            dx = dx_part + _shift_left(dcs, d_prev)
        dout = torch.cat([dx.to(dt), dskip], dim=-1).to(f32)
        dz = dout @ w_out[l].to(dt).to(f32)             # (.., G/2)
        da = dz * sb * (1.0 - ta * ta)
        db = dz * ta * sb * (1.0 - sb)
        dg = torch.cat([da, db], dim=-1).to(dt).to(f32)
        dcx, dcs, dcc = (dg @ w_in_l).split([C, C, M], dim=-1)
        dx_part = dx + dcx
        d_prev = d
        dcond = dcond + dcc
        if want_wgrads:
            z = (ta * sb).to(dt).to(f32)
            grads.append(flow_stack_wgrads_reference(x, cond, dg, dout, z, d))
    dx = dx_part + _shift_left(dcs, d_prev)
    if not want_wgrads:
        return dx.to(dt), dcond.to(dt)
    grads.reverse()
    return (dx.to(dt), dcond.to(dt),
            *(torch.stack(gs) for gs in zip(*grads)))


def flow_stack_wgrads_reference(x, cond, dg, dout, z, dilation: int):
    """One layer's weight gradients in fp32 from its saved input x (B, T, C),
    cond (B, T, M) and the backward's dg (B, T, G), dout (B, T, C+S) and
    z (B, T, G/2): (dw_in (G, 2C+M), db_g (G), dw_out (C+S, G/2),
    db_rs (C+S)), dW = dg^T [x | shift(x, d) | cond] and dout^T z, in the
    weights' (out, in) layout (the plain version of kernel 3's
    weight-gradient GEMM)."""
    f32 = torch.float32
    cat = torch.cat([x, shift_right(x, dilation), cond.to(x.dtype)],
                    dim=-1).to(f32)
    dg, dout, z = dg.to(f32), dout.to(f32), z.to(f32)
    return (dg.reshape(-1, dg.shape[-1]).mT @ cat.reshape(-1, cat.shape[-1]),
            dg.sum((0, 1)),
            dout.reshape(-1, dout.shape[-1]).mT @ z.reshape(-1, z.shape[-1]),
            dout.sum((0, 1)))


def _check_operands(tensors: dict, fp32: Sequence[str], shapes: dict,
                    dims, built: Sequence[tuple] | None,
                    dilations: Sequence[int], L: int,
                    max_layers: int | None = None,
                    dtype=torch.bfloat16) -> None:
    """The checks every kernel wrapper makes: the tensors named in `fp32`
    are float32, the others `dtype`; `built` lists the (C, G, S, M) the
    kernel is compiled for (None: the general bodies, whose widths
    `generic_limits` checks, and which need `row_alignment` where the wgmma
    bodies need 16 bytes); the first tensor is the one the others must
    share a CUDA device with."""
    for name, t in tensors.items():
        want = torch.float32 if name in fp32 else dtype
        if t.dtype != want:
            raise ValueError(f"{name} must be {str(want)[6:]}, got {t.dtype}")
    if built is not None and dims not in built:
        raise ValueError(f"kernel is built for (C, G, S, M) in {list(built)}, "
                         f"got {dims}")
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    if len(dilations) != L or min(dilations) < 1:
        raise ValueError(f"need {L} dilations >= 1, got {tuple(dilations)}")
    B, T = shapes["cond"][:2]
    if not 1 <= B <= 65535 or T < 1 or (max_layers and L > max_layers):
        raise ValueError(f"unsupported B={B}, T={T}, L={L}")
    first, lead = next(iter(tensors.items()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != lead.device:
            raise ValueError(f"{name} must be on {first}'s CUDA device, got "
                             f"{t.device} ({first} on {lead.device})")
        align = 16 if built is not None else row_alignment(t)
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name} must be contiguous and {align}-byte "
                             f"aligned")


def row_alignment(t: torch.Tensor) -> int:
    """The alignment the general bodies need of a tensor: that of each of
    its rows (the largest power of two up to 16 dividing the last
    dimension's bytes, at least one element), since they read and write 16
    bytes at a time only where a row's width allows it.  A layer's slice of
    a stack at C = 5 in fp32 is 4-byte aligned, and taken."""
    n = (t.shape[-1] if t.dim() else 1) * t.element_size()
    align = 16
    while n % align:
        align //= 2
    return max(align, t.element_size())


def _stack_dims(x0, cond, w_in, w_out):
    if x0.dim() != 3 or cond.dim() != 3:
        raise ValueError("x0 and cond must be (B, T, channels)")
    B, T, C = x0.shape
    L, G, _ = w_in.shape
    return B, T, C, L, G, w_out.shape[1] - C, cond.shape[-1]


def _weight_shapes(L, C, G, S, M) -> dict:
    return {"w_in": (L, G, 2 * C + M), "b_g": (L, G),
            "w_out": (L, C + S, G // 2)}


def _check_stack(x0, cond, w_in, b_g, w_out, b_rs, dilations, built,
                 max_layers=None, dtype=torch.bfloat16) -> None:
    B, T, C, L, G, S, M = _stack_dims(x0, cond, w_in, w_out)
    _check_operands(
        dict(x0=x0, cond=cond, w_in=w_in, b_g=b_g, w_out=w_out, b_rs=b_rs),
        ("b_g", "b_rs"),
        {"cond": (B, T, M), **_weight_shapes(L, C, G, S, M),
         "b_rs": (L, C + S)},
        (C, G, S, M), built, dilations, L, max_layers, dtype)


def _check_backward(acts, cond, w_in, b_g, w_out, dskip, dilations, built,
                    dtype=torch.bfloat16) -> None:
    B, T, C, L, G, S, M = _stack_dims(acts[0], cond, w_in, w_out)
    _check_operands(
        dict(acts=acts, cond=cond, w_in=w_in, b_g=b_g, w_out=w_out,
             dskip=dskip),
        ("b_g",),
        {"acts": (len(w_in), B, T, C), "cond": (B, T, M),
         **_weight_shapes(L, C, G, S, M), "dskip": (B, T, S)},
        (C, G, S, M), built, dilations, L, dtype=dtype)


def _acts_dims(acts, cond, w_in, w_out):
    if acts.dim() != 4:
        raise ValueError("acts must be (L, B, T, C)")
    return _stack_dims(acts[0], cond, w_in, w_out)


def check_kernel_args(x0, cond, w_in, b_g, w_out, b_rs,
                      dilations: Sequence[int],
                      kernel_dims=(KERNEL_DIMS,)) -> None:
    """Raise ValueError on anything a forward kernel does not take: the
    inference kernel (`kernel_dims=(KERNEL_DIMS,)`, at most 32 layers) or
    kernel 2 (`TRAIN_KERNEL_DIMS`).  `kernel_dims` lists the (C, G, S, M)
    the kernel is built for."""
    _check_stack(x0, cond, w_in, b_g, w_out, b_rs, dilations,
                 tuple(kernel_dims),
                 32 if tuple(kernel_dims) == (KERNEL_DIMS,) else None)


def check_train_backward_args(acts, cond, w_in, b_g, w_out, dskip,
                              dilations: Sequence[int]) -> None:
    """Raise ValueError on anything kernel 3 (the fused backward) does not
    take."""
    _acts_dims(acts, cond, w_in, w_out)
    _check_backward(acts, cond, w_in, b_g, w_out, dskip, dilations,
                    TRAIN_KERNEL_DIMS)


def check_generic_args(x0, cond, w_in, b_g, w_out, b_rs,
                       dilations: Sequence[int]) -> None:
    """Raise ValueError on a stack (in `flow_stack`'s layout) that the
    general forward body does not take: a dtype or widths outside
    `generic_limits`, operands not all in x0's dtype (the biases fp32),
    wrong shapes, then a tensor off x0's CUDA device, non-contiguous or not
    16-byte aligned."""
    _, _, C, _, G, S, M = _stack_dims(x0, cond, w_in, w_out)
    why = generic_limits(x0.dtype, C, G, S, M)
    if why:
        raise ValueError(why)
    _check_stack(x0, cond, w_in, b_g, w_out, b_rs, dilations, None,
                 dtype=x0.dtype)


def check_generic_backward_args(acts, cond, w_in, b_g, w_out, dskip,
                                dilations: Sequence[int]) -> None:
    """Raise ValueError on anything kernel 3's general body does not take,
    as `check_generic_args` with the backward's limits."""
    _, _, C, _, G, S, M = _acts_dims(acts, cond, w_in, w_out)
    why = generic_limits(acts.dtype, C, G, S, M, backward=True)
    if why:
        raise ValueError(why)
    _check_backward(acts, cond, w_in, b_g, w_out, dskip, dilations, None,
                    dtype=acts.dtype)


def _device_call(fn_name: str, device, *args) -> None:
    """Call one of the kernel library's entry points on `device`'s current
    stream; raise if it reports a CUDA error."""
    from pwn_tpu_torch.ops import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name} failed: "
                           + lib.pwn_cuda_error_string(err).decode())


def segment_length(B: int, T: int, n_sm: int, tile: int) -> int:
    """Samples per block: split each row so that B * segments is about one
    block per SM (each block recomputes a sum(d) halo before its segment),
    rounded up to whole tiles."""
    n_seg = max(1, n_sm // B)
    seg = -(-T // n_seg)
    return max(tile, -(-seg // tile) * tile)


def flow_stack(x0, cond, w_in, b_g, w_out, b_rs, dilations: Sequence[int],
               *, segment: int | None = None,
               packed: GenericWeights | None = None) -> torch.Tensor:
    """Whole-stack forward; see the module docstring.  On a CUDA tensor,
    kernel 1 where `kernel1_takes` the stack, else kernel 5's accumulate
    epilogue once per layer (`gated_layer.flow_stack_by_layers`), which
    keeps the same rounding; a stack that neither kernel takes raises.
    `segment` overrides kernel 1's samples per block (default
    `segment_length`); the result does not depend on it.  `packed` is
    `pack_generic(w_in, w_out)` (built here where it is None and the
    general body runs).
    `flow_stack.launches` counts kernel 1's launches (kernel 5's count on
    `gated_layer.launches`)."""
    if x0.device.type == "cpu":
        return flow_stack_reference(x0, cond, w_in, b_g, w_out, b_rs,
                                    dilations)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x0, cond, w_in, b_g, w_out, b_rs)):
        raise RuntimeError("the flow_stack kernels have no backward; "
                           "call them under torch.no_grad()")
    _, _, C, _, G, S, M = _stack_dims(x0, cond, w_in, w_out)
    if not kernel1_takes(dilations, C, G, S, M, x0.dtype):
        from pwn_tpu_torch.ops.gated_layer import flow_stack_by_layers

        return flow_stack_by_layers(x0, cond, w_in, b_g, w_out, b_rs,
                                    dilations, packed=packed)
    check_kernel_args(x0, cond, w_in, b_g, w_out, b_rs, dilations)
    from pwn_tpu_torch.ops import _build

    lib = _build.load_library()
    B, T, C = x0.shape
    L, G, _ = w_in.shape
    S = w_out.shape[1] - C
    props = torch.cuda.get_device_properties(x0.device)
    smem = lib.pwn_flow_stack_smem_bytes(sum(dilations))
    if smem > props.shared_memory_per_block_optin:
        raise ValueError(
            f"sum(dilations) = {sum(dilations)} needs {smem} bytes of shared "
            f"memory per block; the card allows "
            f"{props.shared_memory_per_block_optin}")
    if segment is None:
        segment = segment_length(B, T, props.multi_processor_count,
                                 lib.pwn_flow_stack_tile_rows())
    skip = torch.empty((B, T, S), dtype=x0.dtype, device=x0.device)
    _device_call(
        "pwn_flow_stack_bf16", x0.device,
        x0.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_g.data_ptr(),
        w_out.data_ptr(), b_rs.data_ptr(), skip.data_ptr(), B, T, L, C, G, S,
        cond.shape[-1], (ctypes.c_int * L)(*dilations), segment)
    flow_stack.launches += 1
    return skip


flow_stack.launches = 0


def flow_stack_train_forward(x0, cond, w_in, b_g, w_out, b_rs,
                             dilations: Sequence[int],
                             packed: GenericWeights | None = None):
    """Kernel 2: the stack forward that also saves every layer's input.
    Returns (skip (B, T, S), acts (L, B, T, C)); on CPU tensors the plain
    `flow_stack_train_reference`.  On a CUDA tensor it runs kernel 5's
    accumulate epilogue once per layer with the residual written into
    acts[l + 1] (`gated_layer.flow_stack_train_by_layers`, the same
    rounding), in the body `kernel_body` picks; what neither body takes
    raises.  It launches no kernel of its own: kernel 5 counts its L
    launches on `gated_layer.launches` (and `.launches_by`, by body).
    `packed`: the general body's weights (`pack_generic`), built here where
    it is None."""
    if x0.device.type == "cpu":
        return flow_stack_train_reference(x0, cond, w_in, b_g, w_out, b_rs,
                                          dilations)
    _, _, C, _, G, S, M = _stack_dims(x0, cond, w_in, w_out)
    if kernel_body(x0.dtype, C, G, S, M) == "wgmma":
        check_kernel_args(x0, cond, w_in, b_g, w_out, b_rs, dilations,
                          kernel_dims=TRAIN_KERNEL_DIMS)
    else:
        check_generic_args(x0, cond, w_in, b_g, w_out, b_rs, dilations)
    from pwn_tpu_torch.ops.gated_layer import flow_stack_train_by_layers

    return flow_stack_train_by_layers(x0, cond, w_in, b_g, w_out, b_rs,
                                      dilations, packed=packed)


def flow_stack_train_backward(acts, cond, w_in, b_g, w_out, dskip,
                              dilations: Sequence[int],
                              want_wgrads: bool = True,
                              packed: GenericWeights | None = None):
    """Kernel 3: the fused backward, with the returns of
    `flow_stack_backward_reference` (its plain version, taken for CPU
    tensors).  On a CUDA tensor, the body `kernel_body(..., backward=True)`
    picks: the wgmma body (bf16 at `TRAIN_KERNEL_DIMS`) or the general one;
    what neither takes raises.  `flow_stack_train_backward.launches` counts
    the kernel calls (one per call), and
    `flow_stack_train_backward.launches_by` the same calls by (C,
    want_wgrads) for the wgmma body and ("generic", C, want_wgrads) for
    the general one, which tells the student's calls with weight gradients
    from the frozen teacher's dx-only ones, and the bodies apart.  The
    general body reads `packed` (`pack_generic(w_in, w_out)`, built here
    where it is None)."""
    if acts.device.type == "cpu":
        return flow_stack_backward_reference(acts, cond, w_in, b_g, w_out,
                                             dskip, dilations, want_wgrads)
    _, _, C, _, G, S, M = _acts_dims(acts, cond, w_in, w_out)
    generic = kernel_body(acts.dtype, C, G, S, M, backward=True) == "generic"
    if generic:
        check_generic_backward_args(acts, cond, w_in, b_g, w_out, dskip,
                                    dilations)
    else:
        check_train_backward_args(acts, cond, w_in, b_g, w_out, dskip,
                                  dilations)
    from pwn_tpu_torch.ops import _build

    L, B, T, C = acts.shape
    G, S, M = w_in.shape[1], dskip.shape[-1], cond.shape[-1]
    dev = acts.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.load_library()
    is_bf16 = int(acts.dtype == torch.bfloat16)
    weights = ((generic_packed(w_in, w_out, packed),) if generic else ())
    ws = torch.empty(lib.pwn_flow_stack_train_bwd_generic_workspace_bytes(
                         B, T, L, C, G, S, M, int(want_wgrads), n_sm)
                     if generic else
                     lib.pwn_flow_stack_train_bwd_workspace_bytes(
                         B, T, C, G, S, M, int(want_wgrads), n_sm),
                     dtype=torch.uint8, device=dev)
    dx = torch.empty((B, T, C), dtype=acts.dtype, device=dev)
    dcond = torch.empty((B, T, M), dtype=acts.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    grads = ((torch.empty(w_in.shape, **f32), torch.empty(b_g.shape, **f32),
              torch.empty(w_out.shape, **f32), torch.empty((L, C + S), **f32))
             if want_wgrads else ())
    ptrs = [g.data_ptr() for g in grads] or [None] * 4
    w_ptrs = ([weights[0].gate.data_ptr(), b_g.data_ptr(),
               weights[0].dz.data_ptr(), weights[0].dcat.data_ptr()]
              if generic else
              [w_in.data_ptr(), b_g.data_ptr(), w_out.data_ptr()])
    _device_call(
        "pwn_flow_stack_train_bwd_" + ("generic" if generic else "bf16"), dev,
        acts.data_ptr(), cond.data_ptr(), dskip.data_ptr(), *w_ptrs,
        dx.data_ptr(), dcond.data_ptr(),
        *ptrs, ws.data_ptr(),
        B, T, L, C, G, S, M, (ctypes.c_int * L)(*dilations),
        int(want_wgrads), n_sm, *((is_bf16,) if generic else ()))
    flow_stack_train_backward.launches += 1
    key = (C, bool(want_wgrads))
    flow_stack_train_backward.launches_by[
        ("generic", *key) if generic else key] += 1
    return (dx, dcond, *grads)


flow_stack_train_backward.launches = 0
flow_stack_train_backward.launches_by = collections.Counter()


def flow_stack_train_wgrads(x, cond, dg, dout, z, dilation: int):
    """Kernel 3's weight-gradient GEMM alone, for one layer: the returns of
    `flow_stack_wgrads_reference` (its plain version, taken for CPU
    tensors) from bf16 operands on the card.  `flow_stack_train_backward`
    runs the same GEMM inside its one library call; this entry point serves
    its tests and timing.  `flow_stack_train_wgrads.launches` counts the
    calls."""
    if x.device.type == "cpu":
        return flow_stack_wgrads_reference(x, cond, dg, dout, z, dilation)
    if x.dim() != 3:
        raise ValueError("x must be (B, T, C)")
    B, T, C = x.shape
    G, M, N = dg.shape[-1], cond.shape[-1], dout.shape[-1]
    _check_operands(
        dict(x=x, cond=cond, dg=dg, dout=dout, z=z), (),
        {"cond": (B, T, M), "dg": (B, T, G), "dout": (B, T, N),
         "z": (B, T, G // 2)},
        (C, G, N - C, M), TRAIN_KERNEL_DIMS, (dilation,), 1)
    from pwn_tpu_torch.ops import _build

    dev = x.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ws = torch.empty(_build.load_library().
                     pwn_flow_stack_train_wgrad_workspace_bytes(
                         B, T, C, G, N - C, M, n_sm),
                     dtype=torch.uint8, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    grads = (torch.empty((G, 2 * C + M), **f32), torch.empty(G, **f32),
             torch.empty((N, G // 2), **f32), torch.empty(N, **f32))
    _device_call(
        "pwn_flow_stack_train_wgrad_bf16", dev,
        x.data_ptr(), cond.data_ptr(), dg.data_ptr(), dout.data_ptr(),
        z.data_ptr(), *(g.data_ptr() for g in grads), ws.data_ptr(),
        B, T, C, G, N - C, M, dilation, n_sm)
    flow_stack_train_wgrads.launches += 1
    return grads


flow_stack_train_wgrads.launches = 0


def generic_wgrad_operands(dg, dout, z):
    """dg (B, T, G), dout (B, T, C+S), z (B, T, G/2) in the layout kernel 3's
    general layer pass stores them for its weight-gradient product: fp32,
    dg's tanh and sigmoid halves each padded to GHp columns, dout padded to
    Np, z to GHp (`generic_pack_dims`)."""
    GH, N = z.shape[-1], dout.shape[-1]
    GHp, Np = _up(GH, GENERIC_BK), _up(N, GENERIC_BK)
    pad = torch.nn.functional.pad
    dg = dg.float()
    return (torch.cat([pad(dg[..., :GH], (0, GHp - GH)),
                       pad(dg[..., GH:], (0, GHp - GH))], -1).contiguous(),
            pad(dout.float(), (0, Np - N)).contiguous(),
            pad(z.float(), (0, GHp - GH)).contiguous())


def flow_stack_train_wgrads_generic(x, cond, dg, dout, z, dilation: int,
                                    stored=None):
    """Kernel 3's general weight-gradient product alone, for one layer: the
    returns of `flow_stack_wgrads_reference` (its plain version, taken for
    CPU tensors) from x and cond in the operand type (fp32 or bf16) and dg,
    dout, z; on the card they go in as `generic_wgrad_operands` lays them
    out (`stored`, built here where it is None).  `flow_stack_train_backward`
    runs the same kernels inside its one library call; this entry point
    serves tests and timing.  `flow_stack_train_wgrads_generic.launches`
    counts the calls."""
    if x.device.type == "cpu":
        return flow_stack_wgrads_reference(x, cond, dg, dout, z, dilation)
    if x.dim() != 3:
        raise ValueError("x must be (B, T, C)")
    B, T, C = x.shape
    G, M, N = dg.shape[-1], cond.shape[-1], dout.shape[-1]
    why = generic_limits(x.dtype, C, G, N - C, M, backward=True)
    if why:
        raise ValueError(why)
    if stored is None:
        stored = generic_wgrad_operands(dg, dout, z)
    d = generic_pack_dims(C, G, N - C, M)
    _check_operands(
        dict(x=x, cond=cond, dg=stored[0], dout=stored[1], z=stored[2]),
        ("dg", "dout", "z"),
        {"cond": (B, T, M), "dg": (B, T, 2 * d["GHp"]),
         "dout": (B, T, d["Np"]), "z": (B, T, d["GHp"])},
        (C, G, N - C, M), None, (dilation,), 1, dtype=x.dtype)
    from pwn_tpu_torch.ops import _build

    dev = x.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.load_library()
    ws = torch.empty(lib.pwn_flow_stack_train_wgrad_generic_workspace_bytes(
        B, T, C, G, N - C, M, n_sm), dtype=torch.uint8, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    grads = (torch.empty((G, 2 * C + M), **f32), torch.empty(G, **f32),
             torch.empty((N, G // 2), **f32), torch.empty(N, **f32))
    _device_call(
        "pwn_flow_stack_train_wgrad_generic", dev,
        x.data_ptr(), cond.data_ptr(), *(t.data_ptr() for t in stored),
        *(g.data_ptr() for g in grads), ws.data_ptr(),
        B, T, C, G, N - C, M, dilation, n_sm,
        int(x.dtype == torch.bfloat16))
    flow_stack_train_wgrads_generic.launches += 1
    return grads


flow_stack_train_wgrads_generic.launches = 0


class FlowStackTrain(torch.autograd.Function):
    """Differentiable stack: forward `flow_stack_train_forward`, which
    saves the per-layer inputs; backward `flow_stack_train_backward`.
    With `want_wgrads=False` (scoring a frozen stack) the weights get no
    gradient.  The weight gradients come back in fp32; autograd casts each
    to its input's dtype, as the JAX VJP returns dW in the weights' dtype."""

    @staticmethod
    def forward(ctx, x0, cond, w_in, b_g, w_out, b_rs, dilations,
                want_wgrads, packed):
        _, _, C, _, G, S, M = _stack_dims(x0, cond, w_in, w_out)
        if x0.is_cuda and kernel_body(x0.dtype, C, G, S, M) == "generic":
            # packed once, for the forward and the backward
            packed = generic_packed(w_in, w_out, packed)
        skip, acts = flow_stack_train_forward(x0, cond, w_in, b_g, w_out,
                                              b_rs, dilations, packed)
        ctx.save_for_backward(acts, cond, w_in, b_g, w_out)
        ctx.dilations, ctx.want_wgrads = tuple(dilations), want_wgrads
        ctx.packed = packed
        return skip

    @staticmethod
    def backward(ctx, dskip):
        acts, cond, w_in, b_g, w_out = ctx.saved_tensors
        dx, dcond, *grads = flow_stack_train_backward(
            acts, cond, w_in, b_g, w_out, dskip.contiguous(), ctx.dilations,
            ctx.want_wgrads, ctx.packed)
        return (dx, dcond, *(grads or [None] * 4), None, None, None)


def flow_stack_train(x0, cond, w_in, b_g, w_out, b_rs,
                     dilations: Sequence[int],
                     packed: GenericWeights | None = None) -> torch.Tensor:
    """The training stack (counterpart of `fused_flow_stack_train`): the
    skip sum, differentiable in every input.  `packed`: the general body's
    weights, as `flow_stack_train_backward` takes them."""
    return FlowStackTrain.apply(x0, cond, w_in, b_g, w_out, b_rs,
                                tuple(dilations), True, packed)


def flow_stack_score(x0, cond, w_in, b_g, w_out, b_rs,
                     dilations: Sequence[int],
                     packed: GenericWeights | None = None) -> torch.Tensor:
    """The frozen-stack scoring variant (counterpart of
    `fused_flow_stack_score`): the backward computes dx and dcond only, and
    the weights' gradients are None."""
    return FlowStackTrain.apply(x0, cond, w_in, b_g, w_out, b_rs,
                                tuple(dilations), False, packed)
