"""One gated residual layer: the plain PyTorch version, the wrapper of its
CUDA kernel, and the differentiable layer (counterpart of
`pwn_tpu/ops/pallas/gated_layer.py`).

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
weights are the reference's `(2C+M, G)` and `(G/2, C+S)` transposed, the
order the CUDA kernel reads its mma B fragments in.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel
(`csrc/gated_layer.cu`, built for (C, G, S, M) = (64, 128, 64, 80) and
(128, 256, 128, 80)) or raises.  Rounding points, kept by both: the GEMMs
accumulate in fp32, the biases and the gates are fp32, z and out are
rounded to the compute dtype, and res is the compute-dtype sum x + out.

`fused_gated_residual` is the reference's differentiable layer on the raw
layer parameters: `FusedGatedResidual`, whose forward is `gated_layer` and
whose backward recomputes the gates in fp32 (the reference's `_fused_bwd`,
which runs in XLA outside any Pallas kernel, so plain matmuls here).
"""

from __future__ import annotations

import torch

from pwn_tpu_torch.ops.conv import shift_right
from pwn_tpu_torch.ops.flow_stack import (_check_operands, _device_call,
                                          _shift_left)

# The reference's time tile: its kernel reaches the tap through the previous
# tile, so it refuses a dilation above one tile.  The CUDA kernel has no
# tile bound; the check is kept so that the two accept the same layers.
TIME_TILE = 512
# the widths the CUDA kernel is built for: (C, G, S, M)
KERNEL_DIMS = ((64, 128, 64, 80), (128, 256, 128, 80))


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
    dt = x.dtype
    f32 = torch.float32
    C = x.shape[-1]
    cat = torch.cat([x, shift_right(x, dilation), cond.to(dt)], dim=-1)
    g = cat.to(f32) @ w_in.to(dt).to(f32).mT + b_g.to(f32)
    a, b = g.chunk(2, dim=-1)
    z = (torch.tanh(a) * torch.sigmoid(b)).to(dt)
    out = (z.to(f32) @ w_out.to(dt).to(f32).mT + b_out.to(f32)).to(dt)
    return x + out[..., :C], out[..., C:]


def check_gated_layer_args(x, cond, w_in, b_g, w_out, b_out,
                           dilation: int) -> None:
    """Raise ValueError on anything the CUDA kernel does not take."""
    if x.dim() != 3 or cond.dim() != 3:
        raise ValueError("x and cond must be (B, T, channels)")
    B, T, C = x.shape
    M = cond.shape[-1]
    G = w_in.shape[0]
    S = w_out.shape[0] - C
    _check_operands(
        dict(x=x, cond=cond, w_in=w_in, b_g=b_g, w_out=w_out, b_out=b_out),
        ("b_g", "b_out"),
        {"cond": (B, T, M), "w_in": (G, 2 * C + M), "b_g": (G,),
         "w_out": (C + S, G // 2), "b_out": (C + S,)},
        (C, G, S, M), KERNEL_DIMS, (dilation,), 1)


def gated_layer(x, cond, w_in, b_g, w_out, b_out, dilation: int):
    """One layer's (res, skip); see the module docstring.
    `gated_layer.launches` counts the kernel launches."""
    if dilation > TIME_TILE:
        raise ValueError(f"dilation {dilation} > TIME_TILE {TIME_TILE}: the "
                         "reference's per-layer kernel does not take it")
    if x.device.type == "cpu":
        return gated_layer_reference(x, cond, w_in, b_g, w_out, b_out,
                                     dilation)
    check_gated_layer_args(x, cond, w_in, b_g, w_out, b_out, dilation)
    B, T, C = x.shape
    G, M, S = w_in.shape[0], cond.shape[-1], w_out.shape[0] - C
    res = torch.empty_like(x)
    skip = torch.empty((B, T, S), dtype=x.dtype, device=x.device)
    _device_call(
        "pwn_gated_layer_bf16", x.device,
        x.data_ptr(), cond.data_ptr(), w_in.data_ptr(), b_g.data_ptr(),
        w_out.data_ptr(), b_out.data_ptr(), res.data_ptr(), skip.data_ptr(),
        B, T, C, G, S, M, dilation)
    gated_layer.launches += 1
    return res, skip


gated_layer.launches = 0


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
    dtype."""
    return FusedGatedResidual.apply(x, cond, w_dilated, b_dilated, w_cond,
                                    b_cond, w_res, b_res, w_skip, b_skip,
                                    dilation, None)
