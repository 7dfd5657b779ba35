"""One gated residual layer: the plain PyTorch version, the wrappers of its
CUDA kernel (kernel 5) in its two epilogues, and the differentiable layer
(counterpart of `pwn_tpu/ops/pallas/gated_layer.py`).

    g    = [x | shift(x, d) | cond] @ W_in + b_g
    z    = tanh(g[..., :G/2]) * sigmoid(g[..., G/2:])
    out  = z @ W_out + b_out
    res  = x + out[..., :C],   skip = out[..., C:]

`gated_layer` takes the packed operands of `pack_layer`:
    x     (B, T, C)        compute dtype
    cond  (B, T, M)        compute dtype
    w_in  (G, 2C+M)        compute dtype, (out, in): input columns
                           [x | shift(x, d) | cond]
    b_g   (G,)             float32, b_dilated + b_cond unrounded
    w_out (C+S, G/2)       compute dtype, (out, in): output rows
                           [residual | skip]
    b_out (C+S,)           float32, [b_res | b_skip] unrounded
and returns (res (B, T, C), skip (B, T, S)) in the compute dtype.  The
weights are the reference's `(2C+M, G)` and `(G/2, C+S)` transposed: the
K-major B operand the CUDA kernel's wgmma reads.

A CPU tensor goes to the plain version; a CUDA tensor goes to one of
kernel 5's two bodies, as `ops/flow_stack.py::kernel_body` picks from the
dtype and widths, or raises: `csrc/gated_layer.cu` (wgmma; bf16 at (C, G,
S, M) = (64, 128, 64, 80), (128, 256, 128, 80) and (256, 512, 256, 80)) or
`csrc/gated_layer_generic.cu` (fp32 FMAs on the CUDA cores; fp32 or bf16
at any other width within `generic_limits`: the 40-mel tiny configs,
every preset in fp32).  Rounding points, kept by all three: the GEMMs
accumulate in fp32, the biases and the gates are fp32, z and out are
rounded to the compute dtype, and res is the compute-dtype sum x + out.

`gated_layer_accumulate` is the same layer in kernel 5's "accumulate"
epilogue, one layer of the whole-stack forward with the reference
megakernel's rounding (`pwn_tpu/ops/pallas/flow_stack.py::_kernel`): the
skip half stays fp32 and is summed across layers in a (B, T, S) buffer,
and only the last layer rounds it.  `flow_stack_by_layers` runs it over a
stack; `ops/flow_stack.py::flow_stack` calls that where kernel 1 does not
take the stack.  `flow_stack_train_by_layers` runs it with every layer's
residual written into the saved inputs: the training forward (kernel 2's
route, `pwn_tpu/ops/pallas/flow_stack.py::_fwd_save_kernel`).

`fused_gated_residual` is the reference's differentiable layer on the raw
layer parameters: `FusedGatedResidual`, whose forward is `gated_layer` and
whose backward recomputes the gates in fp32 (the reference's `_fused_bwd`,
which runs in XLA outside any Pallas kernel, so plain matmuls here).
"""

from __future__ import annotations

import collections
from typing import Sequence

import torch

from pwn_tpu_torch.ops.conv import shift_right
from pwn_tpu_torch.ops.flow_stack import (TRAIN_KERNEL_DIMS, GenericWeights,
                                          _check_operands, _device_call,
                                          _shift_left, generic_limits,
                                          generic_packed, kernel_body,
                                          layer_out, row_alignment)

# The reference's time tile: its kernel reaches the tap through the previous
# tile, so its per-layer API (`fused_gated_residual`) refuses a dilation
# above one tile, and so does the port's.  The CUDA bodies have no tile
# bound: a stack with such a dilation runs "layer" (models/modules.py),
# the counterpart of the reference's XLA per-layer form, through
# `FusedGatedResidual` and `gated_layer`, which take any dilation.
TIME_TILE = 512
# the widths the wgmma body is built for: (C, G, S, M), kernel 3's too
KERNEL_DIMS = TRAIN_KERNEL_DIMS


def pack_layer(w_dilated, b_dilated, w_cond, b_cond, w_res, b_res, w_skip,
               b_skip, dtype: torch.dtype):
    """One layer's parameters -> (w_in, b_g, w_out, b_out) in `gated_layer`'s
    layout, as `_fused_forward` packs them: the weights cast to `dtype`, the
    summed biases kept in float32 without rounding."""
    w_in = torch.cat([w_dilated[1], w_dilated[0], w_cond], dim=0).to(dtype)
    w_out = torch.cat([w_res, w_skip], dim=1).to(dtype)
    return (w_in.mT.contiguous(), (b_dilated + b_cond).float().contiguous(),
            w_out.mT.contiguous(), torch.cat([b_res, b_skip]).float())


def gated_layer_reference(x, cond, w_in, b_g, w_out, b_out, dilation: int):
    """Plain PyTorch layer in the module docstring's rounding order."""
    C = x.shape[-1]
    out = layer_out(x, cond, w_in, b_g, w_out, b_out, dilation).to(x.dtype)
    return x + out[..., :C], out[..., C:]


def _layer_dims(x, cond, w_in, w_out):
    if x.dim() != 3 or cond.dim() != 3:
        raise ValueError("x and cond must be (B, T, channels)")
    C = x.shape[-1]
    return C, w_in.shape[0], w_out.shape[0] - C, cond.shape[-1]


def _check_layer(x, cond, w_in, b_g, w_out, b_out, dilation: int,
                 built) -> None:
    C, G, S, M = _layer_dims(x, cond, w_in, w_out)
    B, T = x.shape[:2]
    _check_operands(
        dict(x=x, cond=cond, w_in=w_in, b_g=b_g, w_out=w_out, b_out=b_out),
        ("b_g", "b_out"),
        {"cond": (B, T, M), "w_in": (G, 2 * C + M), "b_g": (G,),
         "w_out": (C + S, G // 2), "b_out": (C + S,)},
        (C, G, S, M), built, (dilation,), 1,
        dtype=torch.bfloat16 if built else x.dtype)


def check_gated_layer_args(x, cond, w_in, b_g, w_out, b_out,
                           dilation: int) -> None:
    """Raise ValueError on anything the wgmma body does not take."""
    _check_layer(x, cond, w_in, b_g, w_out, b_out, dilation, KERNEL_DIMS)


def check_generic_layer_args(x, cond, w_in, b_g, w_out, b_out,
                             dilation: int) -> None:
    """Raise ValueError on anything kernel 5's general body does not take:
    a dtype or widths outside `generic_limits` (named there), operands not
    all in x's dtype (the biases fp32), wrong shapes, then a tensor off
    x's CUDA device, non-contiguous or not 16-byte aligned."""
    why = generic_limits(x.dtype, *_layer_dims(x, cond, w_in, w_out))
    if why:
        raise ValueError(why)
    _check_layer(x, cond, w_in, b_g, w_out, b_out, dilation, None)


def _kernel_weights(body: str, w_in, w_out, packed):
    """The weights a body's launch reads: the wgmma body's (out, in)
    matrices, or the general body's packed gate and out matrices."""
    if body == "wgmma":
        return w_in, w_out
    packed = generic_packed(w_in, w_out, packed)
    return packed.gate, packed.out


def _count(body: str, epilogue: str, C: int) -> None:
    gated_layer.launches += 1
    gated_layer.launches_by[(body, epilogue)] += 1
    gated_layer.launches_by_width[C] += 1


def gated_layer(x, cond, w_in, b_g, w_out, b_out, dilation: int):
    """One layer's (res, skip); see the module docstring.
    `gated_layer.launches` counts the kernel launches of both epilogues and
    both bodies, `gated_layer.launches_by` the same by (body, epilogue):
    ("wgmma" | "generic", "layer" | "accumulate"), and
    `gated_layer.launches_by_width` by C (a wide teacher's launches apart
    from its student's).  The general body reads
    the weights packed (`ops/flow_stack.py::pack_generic`), here, per call
    (the per-layer "layer" mode; the stack routes pack once)."""
    if x.device.type == "cpu":
        return gated_layer_reference(x, cond, w_in, b_g, w_out, b_out,
                                     dilation)
    body = kernel_body(x.dtype, *_layer_dims(x, cond, w_in, w_out))
    if body == "wgmma":
        check_gated_layer_args(x, cond, w_in, b_g, w_out, b_out, dilation)
    else:
        check_generic_layer_args(x, cond, w_in, b_g, w_out, b_out, dilation)
    B, T, C = x.shape
    G, M, S = w_in.shape[0], cond.shape[-1], w_out.shape[0] - C
    res = torch.empty_like(x)
    skip = torch.empty((B, T, S), dtype=x.dtype, device=x.device)
    w_in, w_out = _kernel_weights(body, w_in, w_out, None)
    _device_call(
        "pwn_gated_layer_" + ("bf16" if body == "wgmma" else "generic"),
        x.device,
        x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_g.data_ptr(),
        w_out.data_ptr(), b_out.data_ptr(), res.data_ptr(), skip.data_ptr(),
        B, T, C, G, S, M, dilation,
        *(() if body == "wgmma" else (int(x.dtype == torch.bfloat16),)))
    _count(body, "layer", C)
    return res, skip


gated_layer.launches = 0
gated_layer.launches_by = collections.Counter()
gated_layer.launches_by_width = collections.Counter()


def gated_layer_accumulate_reference(x, cond, w_in, b_g, w_out, b_rs,
                                     dilation: int, skip_acc, *, first: bool,
                                     last: bool, out=None):
    """Plain PyTorch accumulate epilogue, with `gated_layer_accumulate`'s
    contract (skip_acc updated in place unless `last`)."""
    C = x.shape[-1]
    o = layer_out(x, cond, w_in, b_g, w_out, b_rs, dilation)
    s = o[..., C:] if first else skip_acc + o[..., C:]
    if last:
        return _into(out, s.to(x.dtype))
    skip_acc.copy_(s)
    return _into(out, x + o[..., :C].to(x.dtype))


def _into(out, value):
    if out is None:
        return value
    out.copy_(value)
    return out


def check_accumulate_args(x, cond, w_in, b_g, w_out, b_rs, dilation: int,
                          skip_acc, out, *, first: bool, last: bool) -> None:
    """Raise ValueError on anything the wgmma body's accumulate epilogue
    does not take: its buffers (`out`, and `skip_acc` unless the layer is
    both first and last), then the layer's operands as
    `check_gated_layer_args`."""
    _check_acc_buffers(x, w_out, skip_acc, out, first, last)
    check_gated_layer_args(x, cond, w_in, b_g, w_out, b_rs, dilation)


def check_generic_accumulate_args(x, cond, w_in, b_g, w_out, b_rs,
                                  dilation: int, skip_acc, out, *,
                                  first: bool, last: bool) -> None:
    """`check_accumulate_args` for the general body: the same buffers (at
    their rows' alignment, `row_alignment`), then the layer's operands as
    `check_generic_layer_args`."""
    _check_acc_buffers(x, w_out, skip_acc, out, first, last, generic=True)
    check_generic_layer_args(x, cond, w_in, b_g, w_out, b_rs, dilation)


def _check_acc_buffers(x, w_out, skip_acc, out, first: bool,
                       last: bool, generic: bool = False) -> None:
    if x.dim() != 3:
        raise ValueError("x and cond must be (B, T, channels)")
    B, T, C = x.shape
    S = w_out.shape[0] - C
    bufs = {"out": (out, x.dtype, (B, T, S) if last else (B, T, C))}
    if not (first and last):
        bufs["skip_acc"] = (skip_acc, torch.float32, (B, T, S))
    for name, (t, dt, shape) in bufs.items():
        align = row_alignment(t) if generic and t is not None else 16
        if (t is None or t.dtype != dt or tuple(t.shape) != shape
                or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % align):
            raise ValueError(f"{name} must be a contiguous, {align}-byte "
                             f"aligned {shape} {dt} tensor on {x.device}")
    if not last and out.data_ptr() == x.data_ptr():
        raise ValueError("res must not overwrite x: other tiles read its taps")


def gated_layer_accumulate(x, cond, w_in, b_g, w_out, b_rs, dilation: int,
                           skip_acc, *, first: bool, last: bool, out=None,
                           packed: GenericWeights | None = None):
    """Kernel 5's "accumulate" epilogue: layer `first` / `last` of the
    whole-stack forward, in its rounding (`flow_stack_reference`).  The
    operands are `gated_layer`'s, with `b_g` and `b_rs` from the stacked
    layout (rounded to the compute dtype, held in fp32).  `skip_acc`
    (B, T, S) fp32 holds the skip sum of the layers before: the first layer
    sets it to its own skip, a middle layer adds to it in place, the last
    leaves it (and it may be None where the layer is both).  Returns the
    layer's res (B, T, C), or for the last layer the stack's output
    bf16(skip_acc + skip) (B, T, S), written into `out` if given.  A CPU
    tensor goes to the plain version; a CUDA tensor to the body
    `kernel_body` picks, or raises.  Each launch counts on
    `gated_layer.launches` and `gated_layer.launches_by`.  `packed`: the
    general body's weights (`ops/flow_stack.py::pack_generic(w_in,
    w_out)`), built here where it is None."""
    if x.device.type == "cpu":
        return gated_layer_accumulate_reference(
            x, cond, w_in, b_g, w_out, b_rs, dilation, skip_acc, first=first,
            last=last, out=out)
    if out is None:
        B, T, C = x.shape
        out = torch.empty((B, T, w_out.shape[0] - C) if last else x.shape,
                          dtype=x.dtype, device=x.device)
    body = kernel_body(x.dtype, *_layer_dims(x, cond, w_in, w_out))
    check = (check_accumulate_args if body == "wgmma"
             else check_generic_accumulate_args)
    check(x, cond, w_in, b_g, w_out, b_rs, dilation, skip_acc, out,
          first=first, last=last)
    B, T, C = x.shape
    G, M, S = w_in.shape[0], cond.shape[-1], w_out.shape[0] - C
    w_in, w_out = _kernel_weights(body, w_in, w_out, packed)
    _device_call(
        "pwn_gated_layer_acc_" + ("bf16" if body == "wgmma" else "generic"),
        x.device,
        x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_g.data_ptr(),
        w_out.data_ptr(), b_rs.data_ptr(),
        None if last else out.data_ptr(),
        None if first and last else skip_acc.data_ptr(),
        out.data_ptr() if last else None,
        B, T, C, G, S, M, dilation, int(first), int(last),
        *(() if body == "wgmma" else (int(x.dtype == torch.bfloat16),)))
    _count(body, "accumulate", C)
    return out


def flow_stack_by_layers(x0, cond, w_in, b_g, w_out, b_rs,
                         dilations: Sequence[int],
                         packed: GenericWeights | None = None) -> torch.Tensor:
    """`flow_stack` on the stacked layout where kernel 1 does not take the
    stack: `gated_layer_accumulate` once per layer over the per-layer views of
    the stacked weights (nothing copied), the fp32 skip sum carried between
    launches and rounded once, the residuals in two buffers taken in turn.
    Returns the skip sum (B, T, S) in the compute dtype.  `packed`: the
    general body's weights for the whole stack (`pack_generic`), built here
    where it is None and that body runs."""
    bufs = [torch.empty_like(x0) for _ in range(min(len(dilations) - 1, 2))]
    return _accumulate_layers(x0, cond, w_in, b_g, w_out, b_rs, dilations,
                              bufs, packed)


def flow_stack_train_by_layers(x0, cond, w_in, b_g, w_out, b_rs,
                               dilations: Sequence[int],
                               packed: GenericWeights | None = None):
    """Kernel 2's route (`ops/flow_stack.py::flow_stack_train_forward` on a
    CUDA tensor): the whole-stack forward that also keeps every layer's
    input, as `flow_stack_by_layers` writing layer l's residual into the
    saved acts[l + 1].  Returns (skip (B, T, S), acts (L, B, T, C)),
    acts[0] = x0, with `flow_stack_train_reference`'s rounding; on CPU
    tensors each layer is the plain accumulate epilogue."""
    L = len(dilations)
    acts = torch.empty((L,) + tuple(x0.shape), dtype=x0.dtype,
                       device=x0.device)
    acts[0].copy_(x0)
    skip = _accumulate_layers(acts[0], cond, w_in, b_g, w_out, b_rs,
                              dilations, acts[1:], packed)
    return skip, acts


def _accumulate_layers(x0, cond, w_in, b_g, w_out, b_rs,
                       dilations: Sequence[int], bufs,
                       packed: GenericWeights | None) -> torch.Tensor:
    """The layer loop of both routes above: layer l (not the last) writes
    its residual into bufs[l % len(bufs)]; the general body's packed
    weights are checked or built once for the stack."""
    L = len(dilations)
    if L < 1 or w_in.dim() != 3 or len(w_in) != L or len(w_out) != L:
        raise ValueError(f"need one (w_in, w_out) per dilation, got "
                         f"{tuple(w_in.shape)}, {tuple(w_out.shape)} for "
                         f"{L} dilations")
    B, T, C = x0.shape
    S = w_out.shape[1] - C
    if x0.is_cuda and kernel_body(x0.dtype, C, w_in.shape[1], S,
                                  cond.shape[-1]) == "generic":
        packed = generic_packed(w_in, w_out, packed)
    skip_acc = (torch.empty((B, T, S), dtype=torch.float32, device=x0.device)
                if L > 1 else None)
    x = x0
    for l, d in enumerate(dilations):
        last = l == L - 1
        x = gated_layer_accumulate(
            x, cond, w_in[l], b_g[l], w_out[l], b_rs[l], d, skip_acc,
            first=l == 0, last=last, out=None if last else bufs[l % len(bufs)],
            packed=None if packed is None else packed.layer(l))
    return x


class FusedGatedResidual(torch.autograd.Function):
    """The differentiable layer.  Forward: `gated_layer` on the packed
    operands (`packed`, or `pack_layer` of the parameters when it is None),
    with cond in x's dtype.  Backward: the reference's recompute VJP
    (`_fused_bwd`): the gates recomputed in fp32 from the saved x and cond,
    every gradient formed in fp32 and cast to its input's dtype; b_cond gets
    b_dilated's gradient."""

    @staticmethod
    def forward(ctx, x, cond, w_dilated, b_dilated, w_cond, b_cond, w_res,
                b_res, w_skip, b_skip, dilation, packed):
        if packed is None:
            packed = pack_layer(w_dilated, b_dilated, w_cond, b_cond, w_res,
                                b_res, w_skip, b_skip, x.dtype)
        ctx.save_for_backward(x, cond, w_dilated, b_dilated, w_cond, b_cond,
                              w_res, b_res, w_skip, b_skip)
        ctx.dilation = dilation
        return gated_layer(x.contiguous(), cond.to(x.dtype).contiguous(),
                           *packed, dilation)

    @staticmethod
    def backward(ctx, dres, dskip):
        (x, cond, w_dilated, b_dilated, w_cond, b_cond, w_res, b_res, w_skip,
         b_skip) = ctx.saved_tensors
        d = ctx.dilation
        f32 = torch.float32
        B, T, C = x.shape
        xf, condf = x.to(f32), cond.to(f32)
        dres, dskip = dres.to(f32), dskip.to(f32)
        w_tap, w_now = w_dilated[0].to(f32), w_dilated[1].to(f32)
        w_cond32 = w_cond.to(f32)
        shifted = shift_right(xf, d)
        g = (xf @ w_now + shifted @ w_tap + condf @ w_cond32
             + (b_dilated + b_cond).to(f32))
        a, b = g.chunk(2, dim=-1)
        ta, sb = torch.tanh(a), torch.sigmoid(b)
        z = ta * sb
        dz = dres @ w_res.to(f32).mT + dskip @ w_skip.to(f32).mT
        dg = torch.cat([dz * sb * (1.0 - ta * ta),
                        dz * ta * sb * (1.0 - sb)], dim=-1)
        dx = dres + dg @ w_now.mT + _shift_left(dg @ w_tap.mT, d)
        dcond = dg @ w_cond32.mT

        def outer(u, v):  # sum over (b, t) of u^T v
            return u.reshape(B * T, -1).mT @ v.reshape(B * T, -1)

        db_dilated = dg.sum((0, 1))
        grads = (
            (dx, x), (dcond, cond),
            (torch.stack([outer(shifted, dg), outer(xf, dg)]), w_dilated),
            (db_dilated, b_dilated), (outer(condf, dg), w_cond),
            (db_dilated, b_cond), (outer(z, dres), w_res),
            (dres.sum((0, 1)), b_res), (outer(z, dskip), w_skip),
            (dskip.sum((0, 1)), b_skip),
        )
        return (*(gr.to(ref.dtype) for gr, ref in grads), None, None)


def fused_gated_residual(x, cond, w_dilated, b_dilated, w_cond, b_cond,
                         w_res, b_res, w_skip, b_skip, *, dilation: int):
    """Differentiable gated residual layer on the raw parameters (the
    reference's signature): returns (res (B, T, C), skip (B, T, S)) in x's
    dtype.  A dilation above TIME_TILE raises ValueError, as the
    reference's does."""
    if dilation > TIME_TILE:
        raise ValueError(f"dilation {dilation} > TIME_TILE {TIME_TILE}: the "
                         "reference's per-layer kernel does not take it")
    return FusedGatedResidual.apply(x, cond, w_dilated, b_dilated, w_cond,
                                    b_cond, w_res, b_res, w_skip, b_skip,
                                    dilation, None)
