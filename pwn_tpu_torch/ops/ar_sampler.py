"""Whole-loop teacher AR sampler: the weight packing, the plain PyTorch
version and the wrapper of the CUDA kernel (counterpart of
`pwn_tpu/ops/pallas/ar_sampler.py`).

Fast WaveNet over T steps: per step the front 1x1, then L layers that
each pop and push a conv-queue slot `t % d_l`, run the gate GEMM on
[x | tap | cond(t)], the gated unit and the out GEMM; then the
relu/1x1/relu/1x1 head and the draw from pre-drawn noise, clipped to
[-1, 1] and fed back.  Two heads share the loop: "mol" consumes
(T, B, K+1) uniforms (K for the Gumbel-max choice, one for the logistic
inverse CDF), "gaussian" (T, B, 1) standard normals.

`ar_sample` takes the packed layout of `stack_teacher_weights`, which is
the reference's:
    front_k (1, C), w_in (L, 2C+M, G), w_out (L, G/2, C+S), head1_k (S, S),
    head2_k (S, head_dim) in the storage dtype (bf16 or fp32);
    front_b (1, C), b_g (L, G), b_rs (L, C+S), head1_b (1, S),
    head2_b (1, head_dim) in fp32,
with cond (B, T, M) in the compute dtype, and returns wav (B, T) fp32.
Compute is fp32 over the stored weights, and the queues are fp32.

A CPU tensor goes to the plain version; a CUDA tensor goes to one of the
kernel's four bodies (`csrc/ar_sampler.cu`) or raises; `ar_body` picks
it from the widths, the layer count and the mixtures alone.  At the widths
the kernel is built for (`AR_KERNEL_DIMS`, at most `AR_MAX_LAYERS` layers
and `AR_MAX_MIXTURES` mixtures) the batch rows run on clusters of
`ar_ranks` blocks, each of which owns its share of every layer's gate
columns; `pack_ar_ranks` lays the weights out for them.  At teacher_lj's
and the tiny teacher's widths ("slices") a cluster of 8 takes one row and
a rank's layer slice streams whole through a shared-memory ring; at the
wide teacher's (`AR_WIDE_DIMS`, "chunks") a cluster of 16 takes two rows,
each weight read serving both, and the slice streams in chunks of 4,096
weights (the source's note).  Every other teacher the reference's sampler
takes (any width with an even G, any mixture count, any depth, within
`generic_ar_limits`) runs the general body ("generic"): one row a
cluster of `AR_GEN_RANKS` blocks at run-time widths, rank j owning
ceil(G/2 / 8) z values (zero-padded), its weights cut into tiles by
`generic_ar_plan` and `pack_ar_generic` and streamed by bulk copy, a
whole layer a copy where one fits a stage.  Its exchange buffer grows with
max(C, S); past what a block holds (max(C, S) above ~3,500) the one-block
body ("block") takes the row, the weights in this module's layout read
from L2 every step.  `ar_geometry` reports what a launch looks like.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from pwn_tpu_torch.ops.flow_stack import SMEM_PER_BLOCK, _device_call
from pwn_tpu_torch.ops.gaussian import sample_from_normals
from pwn_tpu_torch.ops.mol import mol_sample_from_uniforms

# the widths (C, G, S, M) the kernel is compiled for: teacher_lj (and
# clarinet_gaussian), tiny_teacher, and the wide teacher (teacher_lj with
# 256 residual, 512 gate and 256 skip channels)
AR_WIDE_DIMS = (256, 512, 256, 80)
AR_KERNEL_DIMS = ((128, 256, 128, 80), (64, 128, 64, 40), AR_WIDE_DIMS)
AR_MAX_LAYERS = 64  # the built bodies' caps (MAX_L, MAX_HD = 3 x 10)
AR_MAX_MIXTURES = 10
AR_BODIES = ("slices", "chunks", "generic", "block")
AR_RANKS = 8  # blocks per cluster: the kernel's split of every layer
AR_WIDE_RANKS = 16  # the same at AR_WIDE_DIMS
AR_CHUNK_ELEMS = 4096  # weights a stage of the wide kernel's ring


_WEIGHTS = ("front_k", "w_in", "w_out", "head1_k", "head2_k")
_BIASES = ("front_b", "b_g", "b_rs", "head1_b", "head2_b")


# the one-block body's partials at least: BLK_THREADS x BLK_VEC_MAX floats
# in the source (`ar_block_kernel`)
_BLOCK_PART_FLOATS = 512 * 8

# The cluster body's constants (`ar_generic_kernel`): blocks a cluster, z
# values a pass (GEN_ZW x GEN_WARPS = 2 x 8), out columns a pass, the barriers'
# bytes, stages of a whole-layer ring, bytes and stages of a tile ring, the
# least weights a tile.
AR_GEN_RANKS = 8
_GEN_ZP = 16
_GEN_OQ = 256
_GEN_BAR_BYTES = 144
_GEN_WHOLE_STAGES = 4
_GEN_TILE_BYTES = 8192
_GEN_TILE_STAGES = 8
_GEN_TILE_MIN = 1024  # bytes: 2 x 32 columns of one 16-byte vector
# the plan's ints in the source's GenPlan order
_GEN_PLAN_KEYS = ("gn", "kb_tc", "kb_x", "rb", "ue", "units", "whole",
                  "stages", "taps", "head")


def head_width(n_mixtures: int, head: str) -> int:
    """The head's output width: 3K for "mol", 2 for "gaussian"."""
    return 2 if head == "gaussian" else 3 * n_mixtures


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def _gen_floats(C: int, G: int, S: int, M: int, HD: int) -> int:
    """The cluster body's fixed fp32 (`GenLayout::NF`): the exchange (2
    parities x 8 ranks x max(C, S)), x, cond(t) (each rounded to 8 floats),
    the tap-and-cond sums, z (2 parities), the skip partials and bias sums,
    relu(skip), the head's hidden and output, the fed-back sample (each
    rounded to 4)."""
    gn = -(-(G // 2) // AR_GEN_RANKS)
    return (2 * AR_GEN_RANKS * _round(max(C, S), 4) + _round(C, 8)
            + _round(M, 8) + _round(2 * gn, 4) + 2 * _round(gn, 4)
            + 4 * _round(S, 4) + _round(HD, 4) + 4)


def generic_tiles(C: int, S: int, M: int, plan: dict):
    """A rank's layer run as the cluster body walks it, tile by tile, with
    each tile's weights: ("tap" | "cond" | "x", first z value, z values,
    first row, rows, weights) for the gate product's segments, per pass of
    16 z values (W_in's tap rows [C, 2C) and cond rows [2C, 2C+M) in
    k-blocks of kb_tc, then for each pass its x rows [0, C) in k-blocks of
    kb_x; a tile holds its z values' tanh and sigmoid columns, column by
    column, each of its rows rounded up to whole 16-byte vectors of `vw`
    weights, zero past the block), then ("out", first column, columns,
    first z row, z rows, weights) for W_out (passes of 256 columns, blocks
    of rb rows, row-major)."""
    gn, vw = plan["gn"], plan["vw"]
    for segs, kb in (((("tap", C), ("cond", M)), plan["kb_tc"]),
                     ((("x", C),), plan["kb_x"])):
        for p0 in range(0, gn, _GEN_ZP):
            zc = min(_GEN_ZP, gn - p0)
            for seg, ks in segs:
                for k0 in range(0, ks, kb):
                    kr = min(kb, ks - k0)
                    yield seg, p0, zc, k0, kr, 2 * zc * _round(kr, vw)
    for n0 in range(0, C + S, _GEN_OQ):
        for r0 in range(0, gn, plan["rb"]):
            nc, rr = min(_GEN_OQ, C + S - n0), min(plan["rb"], gn - r0)
            yield "out", n0, nc, r0, rr, nc * rr


def generic_ar_plan(C: int, G: int, S: int, M: int, HD: int, L: int,
                    weight_bytes: int) -> dict | None:
    """How the cluster body runs these widths (`GenPlan` in the source), or
    None where no plan fits a block's shared memory.  gn = ceil(G/2 / 8) z
    values a rank, vw weights in 16 bytes.  The taps are held (L x
    round8(C) floats) where they leave room for two 8 KB tiles (each
    layer's dilation, queue offset and slots take 16 bytes); a layer's
    run moves whole where two stages of it fit (up to 4: `whole`, one unit
    a layer), else in tiles of at most 8 KB, one unit each (2 to 8 stages;
    k-blocks of kb_tc / kb_x rows, whole vectors, W_out blocks of rb rows);
    the head's weights are held where they fit what is left.  `smem` is
    the launch's dynamic shared memory."""
    wb = weight_bytes
    vw = 16 // wb
    gn = -(-(G // 2) // AR_GEN_RANKS)
    NO = C + S
    fixed = _GEN_BAR_BYTES + 4 * _gen_floats(C, G, S, M, HD)
    if fixed + 2 * _GEN_TILE_MIN > SMEM_PER_BLOCK:
        return None
    fixed += 16 * L  # each layer's dilation, queue offset and two slots
    if fixed + 2 * _GEN_TILE_MIN > SMEM_PER_BLOCK:
        return None
    taps_b = 4 * L * _round(C, 8)
    taps = fixed + taps_b + 2 * _GEN_TILE_BYTES <= SMEM_PER_BLOCK
    room = SMEM_PER_BLOCK - fixed - (taps_b if taps else 0)
    layer = (2 * gn * (2 * _round(C, vw) + _round(M, vw)) + gn * NO)
    plan = {"gn": gn, "vw": vw, "taps": int(taps)}
    if 2 * _round(layer, vw) * wb <= room:
        ue = _round(layer, vw)
        plan.update(whole=1, ue=ue, units=1, kb_tc=_round(max(C, M), vw),
                    kb_x=_round(C, vw), rb=gn,
                    stages=min(_GEN_WHOLE_STAGES, room // (ue * wb)))
    else:
        ub = min(_GEN_TILE_BYTES, room // 2 // 16 * 16)
        ue = ub // wb
        kb = ue // (2 * min(_GEN_ZP, gn)) // vw * vw
        plan.update(whole=0, ue=ue, kb_tc=min(_round(max(C, M), vw), kb),
                    kb_x=min(_round(C, vw), kb),
                    rb=min(gn, ue // min(_GEN_OQ, NO)),
                    stages=min(_GEN_TILE_STAGES, room // ub))
        plan["units"] = sum(1 for _ in generic_tiles(C, S, M, plan))
    room -= plan["stages"] * ue * wb
    head_b = -(-wb * S * (S + HD) // 16) * 16
    plan["head"] = int(head_b <= room)
    plan["smem"] = (fixed + taps_b * plan["taps"] + head_b * plan["head"]
                    + plan["stages"] * ue * wb)
    return plan


def generic_ar_smem_bytes(C: int, G: int, S: int, M: int, HD: int, L: int,
                          weight_bytes: int) -> int | None:
    """The cluster body's dynamic shared memory at these widths, layers and
    weight bytes (`GenLayout::bytes` in the source, for `generic_ar_plan`'s
    plan), or None where no plan fits."""
    plan = generic_ar_plan(C, G, S, M, HD, L, weight_bytes)
    return plan and plan["smem"]


def block_ar_smem_bytes(C: int, G: int, S: int, M: int, HD: int) -> int:
    """The one-block body's shared memory, all of it dynamic
    (`blk_smem_floats` in the source): the fed-back sample, [x | tap |
    cond(t)], z, skip, relu(skip), the head's hidden and output, and the
    products' partials, all fp32.  The weights and the queues stay in
    global memory, so the layer count and K set no bound beyond HD's
    floats."""
    part = max(G, C + S, HD, _BLOCK_PART_FLOATS)
    return 4 * (1 + (2 * C + M) + G // 2 + 3 * S + HD + part)


def generic_ar_limits(C: int, G: int, S: int, M: int, HD: int) -> str | None:
    """Why no general body takes these widths, or None where one does: C,
    S, M, HD >= 1, an even G >= 2, and a plan of the cluster body
    (`generic_ar_plan`, fp32 weights, which need the most) or else the
    one-block body's shared memory (`block_ar_smem_bytes`) within
    SMEM_PER_BLOCK.  Any number of layers and of mixtures within that."""
    if min(C, S, M, HD) < 1 or G < 2 or G % 2:
        return (f"the general AR body takes C, S, M, head width >= 1 and an "
                f"even G >= 2, got (C, G, S, M, HD) = {(C, G, S, M, HD)}")
    if generic_ar_plan(C, G, S, M, HD, 1, 4) is not None:
        return None
    smem = block_ar_smem_bytes(C, G, S, M, HD)
    if smem > SMEM_PER_BLOCK:
        return (f"the general AR body needs {smem} bytes of shared memory at "
                f"(C, G, S, M, HD) = {(C, G, S, M, HD)} in one block, and "
                f"{_GEN_BAR_BYTES + 4 * _gen_floats(C, G, S, M, HD)} before "
                f"its weight ring in a cluster; a block has {SMEM_PER_BLOCK} "
                f"(generic_ar_limits)")
    return None


def ar_body(C: int, G: int, S: int, M: int, L: int, K: int,
            head: str = "mol") -> str:
    """Which body of kernel 4 a call reaches: "slices" at teacher_lj's and
    the tiny teacher's widths and "chunks" at the wide teacher's, each with
    at most AR_MAX_LAYERS layers and (MoL) AR_MAX_MIXTURES mixtures;
    "generic" for every other teacher with a plan of the cluster body
    (`generic_ar_plan`), "block" for the rest within `generic_ar_limits`;
    else ValueError naming that limit.  The widths, L and K alone decide,
    so the answer is the same on the CPU and on the card."""
    built = L <= AR_MAX_LAYERS and (head == "gaussian"
                                    or 1 <= K <= AR_MAX_MIXTURES)
    if built and (C, G, S, M) in AR_KERNEL_DIMS:
        return "chunks" if (C, G, S, M) == AR_WIDE_DIMS else "slices"
    hd = head_width(K, head)
    why = generic_ar_limits(C, G, S, M, hd)
    if why:
        raise ValueError(f"no AR body takes L={L}, K={K} at (C, G, S, M) = "
                         f"{(C, G, S, M)}: the built bodies take "
                         f"{list(AR_KERNEL_DIMS)} with at most "
                         f"{AR_MAX_LAYERS} layers and {AR_MAX_MIXTURES} "
                         f"mixtures, and {why}")
    return "generic" if generic_ar_plan(C, G, S, M, hd, L, 4) else "block"


def resolve_ar_body(C: int, G: int, S: int, M: int, L: int, K: int,
                    head: str, body: str | None = None) -> str:
    """The body a call runs: `body` if given ("generic" wherever the
    cluster body has a plan, "block" wherever the one-block body's shared
    memory fits, a built body only where `ar_body` picks it), else
    `ar_body`'s pick; ValueError for any other."""
    if body not in (None, *AR_BODIES):
        raise ValueError(f"body {body!r}; one of {AR_BODIES}")
    picked = ar_body(C, G, S, M, L, K, head)
    hd = head_width(K, head)
    takes = {"generic": generic_ar_plan(C, G, S, M, hd, L, 4) is not None,
             "block": block_ar_smem_bytes(C, G, S, M, hd) <= SMEM_PER_BLOCK}
    if body is not None and not takes.get(body, body == picked):
        raise ValueError(f"the {body!r} body is not built for L={L}, K={K} "
                         f"at (C, G, S, M) = {(C, G, S, M)}; ar_body picks "
                         f"{picked!r}")
    return body or picked


def ar_ranks(C: int, G: int, S: int, M: int) -> int:
    """Blocks per cluster of the kernel at these widths."""
    return AR_WIDE_RANKS if (C, G, S, M) == AR_WIDE_DIMS else AR_RANKS


@torch.no_grad()
def stack_teacher_weights(stack, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack a teacher `WaveNetStack`'s parameters into the kernel's layout
    (module docstring), as the reference packs the flax tree: weights
    rounded to `dtype`, biases summed and held in fp32 unrounded, gate
    operand order [w_dilated[1]; w_dilated[0]; w_cond] to match the
    concat [x_now, tap, cond]."""
    layers = stack.layers

    def stk(name):
        return torch.stack([getattr(lp, name) for lp in layers])

    w_dil = stk("w_dilated")
    out = dict(
        front_k=stack.front.kernel[0].to(dtype),
        front_b=stack.front.bias[None].float(),
        w_in=torch.cat([w_dil[:, 1], w_dil[:, 0], stk("w_cond")],
                       dim=1).to(dtype),
        b_g=(stk("b_dilated") + stk("b_cond")).float(),
        w_out=torch.cat([stk("w_res"), stk("w_skip")], dim=2).to(dtype),
        b_rs=torch.cat([stk("b_res"), stk("b_skip")], dim=1).float(),
        head1_k=stack.head1.kernel[0].to(dtype),
        head1_b=stack.head1.bias[None].float(),
        head2_k=stack.head2.kernel[0].to(dtype),
        head2_b=stack.head2.bias[None].float(),
    )
    return {k: v.detach().contiguous() for k, v in out.items()}


def pack_ar_ranks(weights: dict, n_ranks: int, layout: str = "slices",
                  chunk_elems: int = AR_CHUNK_ELEMS) -> dict:
    """Split `stack_teacher_weights`' gate layers among `n_ranks` blocks:
    rank j owns gate columns [j*GH/n, (j+1)*GH/n) of the tanh half and the
    same of the sigmoid half (GH = G/2), and those rows of W_out.  Returns
    `w`, (n_ranks, L, 2GH/n*(2C+M) + GH/n*(C+S)) in the storage dtype, one
    contiguous run per rank and layer, and `b_g`, (n_ranks, L, 2GH/n) fp32,
    its gate biases, tanh slice then sigmoid partners.  Plain torch, on the
    weights' device.

    layout "slices": the run is its W_in columns (2GH/n x (2C+M): column by
    column, tanh then sigmoid, each column's 2C+M weights contiguous), then
    its W_out rows (GH/n x (C+S)).

    layout "chunks" (the wide kernel's): the run is the order in which the
    kernel consumes it, in chunks of at most `chunk_elems` weights (the
    kernel's WIDE_CHUNK_E, AR_CHUNK_ELEMS: 8 KB in bf16): W_in's tap and
    cond rows [C, 2C+M), then its x rows [0, C), KCH rows a chunk, then
    W_out's rows, ZR a chunk (`chunk_geometry`).  A gate chunk holds the
    rank's 2GH/n columns one after the other, warp w's 2 ZW together (its ZW
    tanh columns, then their sigmoid partners); within a column, its 16-byte
    vector o holds rows 4o + i, 4 kc/VW + 4o + i, ... (i < 4; kc the
    chunk's rows, VW weights in 16 bytes).  A W_out chunk holds, for each
    group of RV rows, output pair q's RV x 2 weights (row-major) for q = 0
    .. (C+S)/2 - 1."""
    if layout not in ("slices", "chunks"):
        raise ValueError(f"layout {layout!r}; one of 'slices', 'chunks'")
    w_in, w_out, b_g = weights["w_in"], weights["w_out"], weights["b_g"]
    L, K, G = w_in.shape
    gh = G // 2
    if gh % n_ranks:
        raise ValueError(f"{gh} gate columns do not split into {n_ranks} ranks")
    gn = gh // n_ranks
    bg = b_g.reshape(L, 2, n_ranks, gn).permute(2, 0, 1, 3)
    bg = bg.reshape(n_ranks, L, 2 * gn).contiguous()
    if layout == "slices":
        # w_in[l, k, h*GH + j*gn + c] -> [j, l, h, c, k]
        win = w_in.reshape(L, K, 2, n_ranks, gn).permute(3, 0, 2, 4, 1)
        # w_out[l, j*gn + i, n] -> [j, l, i, n]
        wout = w_out.reshape(L, n_ranks, gn, -1).permute(1, 0, 2, 3)
        return {"w": torch.cat([win.reshape(n_ranks, L, -1),
                                wout.reshape(n_ranks, L, -1)],
                               dim=2).contiguous(),
                "b_g": bg}
    NO = w_out.shape[-1]
    C = NO // 2  # the kernel takes S = C
    geo = chunk_geometry(C, G, NO - C, K - 2 * C, n_ranks, w_in.element_size(),
                         chunk_elems)
    zw, vw, rv, zr = geo["ZW"], geo["VW"], geo["RV"], geo["ZR"]
    # w_in[l, k, h*GH + j*gn + w*zw + a] -> [j, l, w, h, a, k]: warp w's
    # tanh columns, then their sigmoid partners
    win = w_in.reshape(L, K, 2, n_ranks, gn // zw, zw)
    win = win.permute(3, 0, 4, 2, 5, 1)
    win = win.reshape(n_ranks, L, 2 * gn, K)
    runs = []
    for k0, kc in geo["gate_chunks"]:
        # position o*vw + 4h + i of a column holds row 4*(kc/vw)*h + 4o + i
        pos = torch.arange(kc)
        o, h, i = pos // vw, pos % vw // 4, pos % 4
        rows = k0 + 4 * (kc // vw) * h + 4 * o + i
        runs.append(win[..., rows.to(win.device)].reshape(n_ranks, L, -1))
    # w_out[l, j*gn + c*zr + g*rv + ii, 2q + e] -> [j, l, c, g, q, ii, e]
    wout = w_out.reshape(L, n_ranks, gn // zr, zr // rv, rv, NO // 2, 2)
    runs.append(wout.permute(1, 0, 2, 3, 5, 4, 6).reshape(n_ranks, L, -1))
    return {"w": torch.cat(runs, dim=2).contiguous(), "b_g": bg}


def chunk_geometry(C: int, G: int, S: int, M: int, n_ranks: int,
                   weight_bytes: int,
                   chunk_elems: int = AR_CHUNK_ELEMS) -> dict:
    """The wide kernel's chunks of a rank's layer run (`WideDims` in the
    source): ZW z values a warp (8 warps), LG = 32/ZW lanes a z value, VW
    weights in 16 bytes, KCH gate rows a chunk (a chunk of the rank's 2GH/n
    columns holds `chunk_elems` weights), RV W_out rows in a 16-byte vector
    of two outputs, ZR W_out rows a chunk; `gate_chunks` lists (first row,
    rows) of each gate chunk in the order they stream: tap and cond rows
    [C, 2C+M), then x rows [0, C)."""
    gn = G // 2 // n_ranks
    zw = gn // 8
    vw = 16 // weight_bytes
    kch = chunk_elems // (2 * gn)
    zr = chunk_elems // (C + S)
    tc = [(C + k, min(kch, C + M - k)) for k in range(0, C + M, kch)]
    x = [(k, kch) for k in range(0, C, kch)]
    return {"ZW": zw, "LG": 32 // zw, "VW": vw, "KCH": kch, "RV": vw // 2,
            "ZR": zr, "gate_chunks": tc + x, "out_chunks": gn // zr}


def pack_ar_generic(weights: dict, plan: dict) -> dict:
    """`stack_teacher_weights`' gate layers in the cluster body's layout for
    `plan` (`generic_ar_plan`): rank j owns z values [j gn, (j+1) gn) of the
    G/2 (zero columns, biases and W_out rows past G/2), its gate tiles' rows
    padded with zeros to whole 16-byte vectors.  Returns `w`,
    (AR_GEN_RANKS, L, units x ue) in the storage dtype: each rank's layer
    run, its `generic_tiles` one after the other (one unit of ue weights,
    zero-padded, where the plan moves a whole layer; else a unit each), and
    `b_g`, (AR_GEN_RANKS, L, 2 gn) fp32: its tanh biases, then sigmoid.
    Plain torch, on the weights' device."""
    w_in, w_out, b_g = weights["w_in"], weights["w_out"], weights["b_g"]
    L, K, G = w_in.shape
    C = weights["front_k"].shape[-1]
    S = w_out.shape[-1] - C
    N, gn, ue = AR_GEN_RANKS, plan["gn"], plan["ue"]
    pad = N * gn - G // 2
    # w_in[l, k, h GH + j gn + i] -> [j, l, i, h, k]
    win = torch.nn.functional.pad(w_in.reshape(L, K, 2, G // 2), (0, pad))
    win = win.reshape(L, K, 2, N, gn).permute(3, 0, 4, 2, 1)
    # w_out[l, j gn + i, n] -> [j, l, i, n]
    wout = torch.nn.functional.pad(w_out, (0, 0, 0, pad))
    wout = wout.reshape(L, N, gn, C + S).transpose(0, 1)
    bg = torch.nn.functional.pad(b_g.reshape(L, 2, G // 2), (0, pad))
    bg = bg.reshape(L, 2, N, gn).permute(2, 0, 1, 3).reshape(N, L, 2 * gn)
    first = {"x": 0, "tap": C, "cond": 2 * C}  # each segment's first row
    tiles = []
    for seg, a0, na, b0, nb, n in generic_tiles(C, S, K - 2 * C, plan):
        if seg == "out":
            t = wout[:, :, b0:b0 + nb, a0:a0 + na]
        else:
            r0 = first[seg] + b0
            t = win[:, :, a0:a0 + na, :, r0:r0 + nb]
            t = torch.nn.functional.pad(t, (0, n // (2 * na) - nb))
        t = t.reshape(N, L, -1)
        if not plan["whole"]:
            t = torch.nn.functional.pad(t, (0, ue - t.shape[-1]))
        tiles.append(t)
    w = torch.cat(tiles, dim=2)
    if plan["whole"]:
        w = torch.nn.functional.pad(w, (0, ue - w.shape[-1]))
    return {"w": w.contiguous(), "b_g": bg.contiguous()}


def queue_offsets(dilations: Sequence[int]) -> list:
    """First queue slot of each layer in the packed (sum(d), ...) queue."""
    return np.cumsum([0, *dilations])[:-1].tolist()


def ar_sample_reference(cond: torch.Tensor, noise: torch.Tensor,
                        weights: dict, *, dilations: Sequence[int],
                        n_mixtures: int, head: str = "mol",
                        log_scale_min: float = -9.0,
                        temperature: float = 1.0) -> torch.Tensor:
    """Plain PyTorch AR loop with the kernel's math: a Python loop over T,
    fp32 compute over the stored weights, fp32 queues (sum(d), B, C), the
    tap read before its slot is overwritten.  Returns wav (B, T) fp32."""
    B, T, _ = cond.shape
    w = {k: v.float() for k, v in weights.items()}
    C = w["front_k"].shape[-1]
    S = w["head1_k"].shape[0]
    offsets = queue_offsets(dilations)
    queue = torch.zeros((sum(dilations), B, C), dtype=torch.float32,
                        device=cond.device)
    x_prev = torch.zeros((B, 1), dtype=torch.float32, device=cond.device)
    wav = torch.empty((T, B), dtype=torch.float32, device=cond.device)
    for t in range(T):
        cond_t = cond[:, t].float()
        x = x_prev * w["front_k"] + w["front_b"]
        skip = torch.zeros((B, S), dtype=torch.float32, device=cond.device)
        for l, d in enumerate(dilations):
            slot = offsets[l] + t % d
            tap = queue[slot].clone()
            queue[slot] = x
            g = torch.cat([x, tap, cond_t], dim=-1) @ w["w_in"][l] + w["b_g"][l]
            a, b = g.chunk(2, dim=-1)
            out = (torch.tanh(a) * torch.sigmoid(b)) @ w["w_out"][l] + w["b_rs"][l]
            x = x + out[:, :C]
            skip = skip + out[:, C:]
        h = torch.relu(skip)
        h = torch.relu(h @ w["head1_k"] + w["head1_b"])
        params_t = h @ w["head2_k"] + w["head2_b"]
        if head == "gaussian":
            x_t = sample_from_normals(params_t, noise[t, :, 0], log_scale_min,
                                      temperature)
        else:
            x_t = mol_sample_from_uniforms(params_t, noise[t], log_scale_min,
                                           temperature)
        wav[t] = x_t
        x_prev = x_t[:, None]
    return wav.T.contiguous()


def check_ar_args(cond, noise, weights: dict, dilations: Sequence[int],
                  n_mixtures: int, head: str, body: str | None = None) -> str:
    """Raise ValueError on anything the kernel does not take; return the
    body the call runs (`resolve_ar_body`).  The width, layer and mixture
    caps of the built bodies apply only to them."""
    if cond.dim() != 3:
        raise ValueError("cond must be (B, T, M)")
    B, T, M = cond.shape
    missing = set(_WEIGHTS + _BIASES) - set(weights)
    if missing:
        raise ValueError(f"weights lack {sorted(missing)}")
    wdt = weights["w_in"].dtype
    L, K_in, G = weights["w_in"].shape
    C = weights["front_k"].shape[-1]
    S = weights["head1_k"].shape[0]
    if head == "gaussian":
        nz = 1
    elif head == "mol":
        nz = n_mixtures + 1
    else:
        raise ValueError(f"head {head!r}; one of 'mol', 'gaussian'")
    hd = head_width(n_mixtures, head)
    body = resolve_ar_body(C, G, S, M, L, n_mixtures, head, body)
    shapes = {"front_k": (1, C), "front_b": (1, C),
              "w_in": (L, 2 * C + M, G), "b_g": (L, G),
              "w_out": (L, G // 2, C + S), "b_rs": (L, C + S),
              "head1_k": (S, S), "head1_b": (1, S),
              "head2_k": (S, hd), "head2_b": (1, hd)}
    tensors = {"cond": cond, "noise": noise, **weights}
    for name, shape in {"noise": (T, B, nz), **shapes}.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    if wdt not in (torch.bfloat16, torch.float32) or any(
            weights[n].dtype != wdt for n in _WEIGHTS):
        raise ValueError("the weights must all be bf16 or all float32")
    if cond.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"cond must be bf16 or float32, got {cond.dtype}")
    for name in ("noise", *_BIASES):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
    if len(dilations) != L or min(dilations) < 1:
        raise ValueError(f"need {L} dilations >= 1, got {tuple(dilations)}")
    if B < 1 or T < 1:
        raise ValueError(f"unsupported B={B}, T={T}")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != cond.device:
            raise ValueError(f"{name} must be on cond's CUDA device, got "
                             f"{t.device} (cond on {cond.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return body


def ar_sample(cond: torch.Tensor, noise: torch.Tensor, weights: dict, *,
              dilations: Sequence[int], n_mixtures: int, head: str = "mol",
              log_scale_min: float = -9.0, temperature: float = 1.0,
              body: str | None = None) -> torch.Tensor:
    """The fused AR loop (counterpart of `ar_sample_pallas`); see the module
    docstring.  Returns wav (B, T) fp32.  `body` runs a given body of the
    kernel ("generic" takes the built widths too; default `ar_body`'s
    pick); a CPU tensor takes the plain version whatever it says.
    `ar_sample.launches` counts the kernel's launches (one per call),
    `ar_sample.launches_by` them by body."""
    if cond.device.type == "cpu":
        return ar_sample_reference(
            cond, noise, weights, dilations=dilations, n_mixtures=n_mixtures,
            head=head, log_scale_min=log_scale_min, temperature=temperature)
    body = check_ar_args(cond, noise, weights, dilations, n_mixtures, head,
                         body)
    if body == "generic":
        args, held = ar_generic_launch_args(cond, noise, weights, dilations,
                                            n_mixtures, head, log_scale_min,
                                            temperature)
        _device_call("pwn_ar_sample_generic", cond.device, *args)
    elif body == "block":
        args, held = ar_block_launch_args(cond, noise, weights, dilations,
                                          n_mixtures, head, log_scale_min,
                                          temperature)
        _device_call("pwn_ar_sample_block", cond.device, *args)
    else:
        args, held = ar_launch_args(cond, noise, weights, dilations,
                                    n_mixtures, head, log_scale_min,
                                    temperature)
        _device_call("pwn_ar_sample", cond.device, *args)
    ar_sample.launches += 1
    ar_sample.launches_by[body] += 1
    return held[0]


def ar_generic_launch_args(cond, noise, weights: dict,
                           dilations: Sequence[int], n_mixtures: int,
                           head: str, log_scale_min: float,
                           temperature: float,
                           wav_ranks: torch.Tensor | None = None):
    """The arguments of the library's `pwn_ar_sample_generic` but the
    stream, for arguments `check_ar_args` passed, and the tensors they
    point into that the caller must hold until the launch: (wav (B, T),
    the packed weights (`pack_ar_generic` for `generic_ar_plan`'s plan at
    these weights' type), the (2, L) int32 dilations and queue offsets on
    the card (d + 1 slots a layer), the zeroed queues (rows of round8(C)
    floats), the plan's ints).
    `wav_ranks` (AR_GEN_RANKS, B, T) is written by a PWN_AR_SAMPLER_CHECK
    build only."""
    B, T, M = cond.shape
    L, _, G = weights["w_in"].shape
    C = weights["front_k"].shape[-1]
    S = weights["head1_k"].shape[0]
    hd = head_width(n_mixtures, head)
    plan = generic_ar_plan(C, G, S, M, hd, L, weights["w_in"].element_size())
    packed = pack_ar_generic(weights, plan)
    slots = [d + 1 for d in dilations]
    dil = torch.tensor([*dilations, *queue_offsets(slots)],
                       dtype=torch.int32).to(cond.device)
    queue = torch.zeros((B, sum(slots), _round(C, 8)), dtype=torch.float32,
                        device=cond.device)
    wav = torch.empty((B, T), dtype=torch.float32, device=cond.device)
    ints = (ctypes.c_int * len(_GEN_PLAN_KEYS))(
        *(plan[k] for k in _GEN_PLAN_KEYS))
    args = (cond.data_ptr(), noise.data_ptr(),
            weights["front_k"].data_ptr(), weights["front_b"].data_ptr(),
            packed["w"].data_ptr(), packed["b_g"].data_ptr(),
            *(weights[n].data_ptr() for n in (
                "b_rs", "head1_k", "head1_b", "head2_k", "head2_b")),
            dil.data_ptr(), queue.data_ptr(), wav.data_ptr(),
            None if wav_ranks is None else wav_ranks.data_ptr(),
            B, T, L, C, G, S, M, hd, n_mixtures, int(head == "gaussian"),
            sum(slots), ints, float(log_scale_min), float(temperature),
            int(weights["w_in"].dtype == torch.bfloat16),
            int(cond.dtype == torch.bfloat16))
    return args, (wav, packed, dil, queue, ints)


def ar_block_launch_args(cond, noise, weights: dict,
                         dilations: Sequence[int], n_mixtures: int,
                         head: str, log_scale_min: float,
                         temperature: float):
    """The arguments of the library's `pwn_ar_sample_block` but the
    stream, for arguments `check_ar_args` passed, and the tensors they
    point into that the caller must hold until the launch: (wav (B, T),
    the (2, L) int32 dilations and queue offsets on the card, the zeroed
    queues).  The weights go in `stack_teacher_weights`' layout."""
    B, T, M = cond.shape
    L, _, G = weights["w_in"].shape
    C = weights["front_k"].shape[-1]
    S = weights["head1_k"].shape[0]
    dil = torch.tensor([*dilations, *queue_offsets(dilations)],
                       dtype=torch.int32).to(cond.device)
    queue = torch.zeros((B, sum(dilations), C), dtype=torch.float32,
                        device=cond.device)
    wav = torch.empty((B, T), dtype=torch.float32, device=cond.device)
    args = (cond.data_ptr(), noise.data_ptr(),
            *(weights[n].data_ptr() for n in (
                "front_k", "front_b", "w_in", "b_g", "w_out", "b_rs",
                "head1_k", "head1_b", "head2_k", "head2_b")),
            dil.data_ptr(), queue.data_ptr(), wav.data_ptr(),
            B, T, L, C, G, S, M, head_width(n_mixtures, head), n_mixtures,
            int(head == "gaussian"), sum(dilations), float(log_scale_min),
            float(temperature), int(weights["w_in"].dtype == torch.bfloat16),
            int(cond.dtype == torch.bfloat16))
    return args, (wav, dil, queue)


def ar_launch_args(cond, noise, weights: dict, dilations: Sequence[int],
                   n_mixtures: int, head: str, log_scale_min: float,
                   temperature: float, wav_ranks: torch.Tensor | None = None,
                   layout: str | None = None,
                   chunk_elems: int = AR_CHUNK_ELEMS,
                   n_ranks: int | None = None):
    """The arguments of the library's `pwn_ar_sample` but the stream, for
    arguments `check_ar_args` passed, and the tensors they point into that
    the caller must hold until the launch: (wav (B, T), the packed
    weights, the zeroed queues).  `layout` overrides the weights' packing
    (by default "chunks" at AR_WIDE_DIMS, else "slices"); `chunk_elems` is
    the "chunks" layout's and `n_ranks` the blocks per cluster (by default
    `ar_ranks`), for a build with another WIDE_CHUNK_E or WIDE_RANKS."""
    B, T, M = cond.shape
    L, _, G = weights["w_in"].shape
    C = weights["front_k"].shape[-1]
    S = weights["head1_k"].shape[0]
    HD = weights["head2_k"].shape[-1]
    if layout is None:
        layout = "chunks" if (C, G, S, M) == AR_WIDE_DIMS else "slices"
    if n_ranks is None:
        n_ranks = ar_ranks(C, G, S, M)
    ranks = pack_ar_ranks(weights, n_ranks, layout, chunk_elems)
    queue = torch.zeros((B, sum(dilations), C), dtype=torch.float32,
                        device=cond.device)
    wav = torch.empty((B, T), dtype=torch.float32, device=cond.device)
    args = (cond.data_ptr(), noise.data_ptr(),
            weights["front_k"].data_ptr(), weights["front_b"].data_ptr(),
            ranks["w"].data_ptr(), ranks["b_g"].data_ptr(),
            *(weights[n].data_ptr() for n in (
                "b_rs", "head1_k", "head1_b", "head2_k", "head2_b")),
            queue.data_ptr(), wav.data_ptr(),
            None if wav_ranks is None else wav_ranks.data_ptr(),
            B, T, L, C, G, S, M, HD, n_mixtures, int(head == "gaussian"),
            (ctypes.c_int * L)(*dilations), float(log_scale_min),
            float(temperature), int(weights["w_in"].dtype == torch.bfloat16),
            int(cond.dtype == torch.bfloat16), n_ranks)
    return args, (wav, ranks, queue)


def ar_geometry(weights: dict, *, n_mixtures: int, head: str,
                cond_dtype: torch.dtype, body: str | None = None) -> dict:
    """What the kernel's launch looks like on the current card for these
    weights, in `body` (`resolve_ar_body`; named under "body"): `rows`
    batch rows and `ranks` blocks a cluster, `stages` of its weight ring,
    `smem` bytes of dynamic shared memory a block, and `clusters`, how
    many of its clusters the card holds at once (a larger batch runs in
    waves).  The general body ("generic") is one row a cluster of
    AR_GEN_RANKS; it adds "plan", `generic_ar_plan`'s plan at these
    weights' type (whether a layer moves whole, the taps and the head
    held).  The one-block body ("block") has no cluster and no ring: one
    block of `threads` threads a row (rows 1, ranks 1, stages 0), and
    `blocks`, how many of them the card holds at once, in place of
    `clusters`."""
    from pwn_tpu_torch.ops import _build

    L, K, G = weights["w_in"].shape
    C = weights["front_k"].shape[-1]
    S = weights["head1_k"].shape[0]
    M, HD = K - 2 * C, weights["head2_k"].shape[-1]
    body = resolve_ar_body(C, G, S, M, L, n_mixtures, head, body)
    lib = _build.load_library()
    types = (int(weights["w_in"].dtype == torch.bfloat16),
             int(cond_dtype == torch.bfloat16))
    extra = {}
    if body == "block":
        out = (ctypes.c_int * 3)()
        err = lib.pwn_ar_sample_block_geometry(
            C, G, S, M, HD, n_mixtures, int(head == "gaussian"), *types, out)
        geo = {"rows": 1, "ranks": 1, "stages": 0, "smem": out[1],
               "blocks": out[2], "threads": out[0]}
    else:
        out = (ctypes.c_int * 5)()
        if body == "generic":
            plan = generic_ar_plan(C, G, S, M, HD, L,
                                   weights["w_in"].element_size())
            ints = (ctypes.c_int * len(_GEN_PLAN_KEYS))(
                *(plan[k] for k in _GEN_PLAN_KEYS))
            err = lib.pwn_ar_sample_generic_geometry(
                L, C, G, S, M, HD, n_mixtures, int(head == "gaussian"),
                *types, ints, out)
            extra = {"plan": plan}
        else:
            err = lib.pwn_ar_sample_geometry(
                L, C, G, S, M, HD, n_mixtures, int(head == "gaussian"),
                *types, ar_ranks(C, G, S, M), out)
        geo = dict(zip(("rows", "ranks", "stages", "smem", "clusters"), out))
    if err:
        raise RuntimeError("the AR geometry query failed: "
                           + lib.pwn_cuda_error_string(err).decode())
    return {"body": body, **geo, **extra}


ar_sample.launches = 0
ar_sample.launches_by = Counter()
