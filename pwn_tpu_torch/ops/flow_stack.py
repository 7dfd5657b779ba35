"""Whole-stack flow forward: the plain PyTorch version and the wrapper of
its CUDA kernel (counterpart of `pwn_tpu/ops/pallas/flow_stack.py`'s
`fused_flow_stack` inference path).

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
as `nn.Linear` stores them, which is also the order the CUDA kernel reads
its mma B fragments in.

A CPU tensor goes to `flow_stack_reference`; a CUDA tensor goes to the
kernel in `csrc/flow_stack.cu` or raises.  There is no fallback between
the two: the plain version is the CPU oracle of the tests and the
on-card comparison of `chip_smoke.py`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from pwn_tpu_torch.ops.conv import shift_right

# the widths the kernel is compiled for (student_iaf): C, G, S, M
KERNEL_DIMS = (64, 128, 64, 80)


def flow_stack_reference(x0, cond, w_in, b_g, w_out, b_rs,
                         dilations: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch stack in the Pallas kernel's rounding order: GEMMs
    accumulate in fp32 (the operands are exact in fp32), bias and gates in
    fp32, z and x rounded to the compute dtype every layer, skip summed in
    fp32 and returned in the compute dtype."""
    dt = x0.dtype
    f32 = torch.float32
    C = x0.shape[-1]
    x = x0
    cond = cond.to(dt)
    skip = torch.zeros(x0.shape[:-1] + (w_out.shape[1] - C,), dtype=f32,
                       device=x0.device)
    for l, d in enumerate(dilations):
        cat = torch.cat([x, shift_right(x, d), cond], dim=-1)
        g = cat.to(f32) @ w_in[l].to(dt).to(f32).mT + b_g[l].to(f32)
        a, b = g.chunk(2, dim=-1)
        z = (torch.tanh(a) * torch.sigmoid(b)).to(dt)
        out = z.to(f32) @ w_out[l].to(dt).to(f32).mT + b_rs[l].to(f32)
        x = x + out[..., :C].to(dt)
        skip = skip + out[..., C:]
    return skip.to(dt)


def check_kernel_args(x0, cond, w_in, b_g, w_out, b_rs,
                      dilations: Sequence[int]) -> None:
    """Raise ValueError on anything the CUDA kernel does not take."""
    tensors = dict(x0=x0, cond=cond, w_in=w_in, b_g=b_g, w_out=w_out,
                   b_rs=b_rs)
    for name in ("x0", "cond", "w_in", "w_out"):
        if tensors[name].dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got "
                             f"{tensors[name].dtype}")
    for name in ("b_g", "b_rs"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got "
                             f"{tensors[name].dtype}")
    if x0.dim() != 3 or cond.dim() != 3:
        raise ValueError("x0 and cond must be (B, T, channels)")
    B, T, C = x0.shape
    M = cond.shape[-1]
    L, G, _ = w_in.shape
    S = w_out.shape[1] - C
    if (C, G, S, M) != KERNEL_DIMS:
        raise ValueError(f"kernel is built for (C, G, S, M) = {KERNEL_DIMS}, "
                         f"got {(C, G, S, M)}")
    want = {
        "cond": (B, T, M), "w_in": (L, G, 2 * C + M), "b_g": (L, G),
        "w_out": (L, C + S, G // 2), "b_rs": (L, C + S),
    }
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    if len(dilations) != L or min(dilations) < 1:
        raise ValueError(f"need {L} dilations >= 1, got {tuple(dilations)}")
    if not 1 <= B <= 65535 or T < 1 or L > 32:
        raise ValueError(f"unsupported B={B}, T={T}, L={L}")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x0.device:
            raise ValueError(f"{name} must be on x0's CUDA device, got "
                             f"{t.device} (x0 on {x0.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def segment_length(B: int, T: int, n_sm: int, tile: int) -> int:
    """Samples per block: split each row so that B * segments is about one
    block per SM (each block recomputes a sum(d) halo before its segment),
    rounded up to whole tiles."""
    n_seg = max(1, n_sm // B)
    seg = -(-T // n_seg)
    return max(tile, -(-seg // tile) * tile)


def flow_stack(x0, cond, w_in, b_g, w_out, b_rs, dilations: Sequence[int],
               *, segment: int | None = None) -> torch.Tensor:
    """Whole-stack forward; see the module docstring.  `segment` overrides
    the kernel's samples per block (default `segment_length`); the result
    does not depend on it.
    `flow_stack.launches` counts the kernel launches."""
    if x0.device.type == "cpu":
        return flow_stack_reference(x0, cond, w_in, b_g, w_out, b_rs,
                                    dilations)
    check_kernel_args(x0, cond, w_in, b_g, w_out, b_rs, dilations)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x0, cond, w_in, b_g, w_out, b_rs)):
        raise RuntimeError("the flow_stack kernel has no backward yet; "
                           "call it under torch.no_grad()")
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
    dils = (ctypes.c_int * L)(*dilations)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pwn_flow_stack_bf16(
            x0.data_ptr(), cond.data_ptr(), w_in.data_ptr(),
            b_g.data_ptr(), w_out.data_ptr(), b_rs.data_ptr(),
            skip.data_ptr(), B, T, L, C, G, S, cond.shape[-1], dils, segment,
            stream,
        )
    if err:
        raise RuntimeError("flow_stack kernel launch failed: "
                           + lib.pwn_cuda_error_string(err).decode())
    flow_stack.launches += 1
    return skip


flow_stack.launches = 0
