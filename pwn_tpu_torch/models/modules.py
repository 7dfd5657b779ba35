"""Building blocks shared by the teacher and the student IAF (counterpart
of `pwn_tpu/models/modules.py`).

Parameters keep the flax tree's names and shapes, channels-last
(`front/kernel (1, Cin, C)`, `layer_i/w_dilated (2, C, G)`, ...,
`upsample/kernel_i (K, Cin, Cout)`), so a state_dict key is the flax path
with "." for "/" (`convert.py`).  Parameters are float32; compute runs in
the configured dtype, and the stack head returns float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pwn_tpu_torch.ops.conv import causal_conv1d, conv_transpose1d, shift_right
from pwn_tpu_torch.ops.flow_stack import (flow_stack, flow_stack_score,
                                          flow_stack_train, kernel_body,
                                          pack_generic)
from pwn_tpu_torch.ops.gated_layer import (TIME_TILE, FusedGatedResidual,
                                           pack_layer)
from pwn_tpu_torch.ops.norm import init_weight_norm_, weight_norm

# WaveNetStack's execution modes and the stack function each one runs:
#   infer  inference forward in the reference megakernel's rounding (fp32
#          skip sum, biases rounded to the compute dtype): on the card kernel
#          1 where `kernel1_takes` the stack, else kernel 5's accumulate
#          epilogue once per layer; no backward there
#   train  forward saving the layer inputs + fused backward (kernels 2, 3)
#   dx     the same forward; backward to the inputs only (a frozen stack)
# and "layer": the layers one by one through `FusedGatedResidual` (kernel 5's
# "layer" epilogue on the card, skip summed in the compute dtype, biases
# unrounded; its backward is plain fp32 matmuls).  The reference's XLA stack
# ("off") is that per-layer form, so it builds "layer".
STACK_FNS = {"infer": flow_stack, "train": flow_stack_train,
             "dx": flow_stack_score}
STACK_MODES = (*STACK_FNS, "layer")


def resolve_stack_mode(flag: str, auto: str,
                       dilations: Sequence[int] = ()) -> str:
    """A config's `fused_layers` flag, or a stack mode itself, -> the
    WaveNetStack mode of a stack of `dilations`.  `auto` is the caller's
    context: "infer" for inference models, "train" for the training loops.
    "auto" takes it; "mega" (the reference's whole-stack kernel) is "train"
    in a training context and "infer" otherwise.  "on" and "layer" are the
    per-layer kernel, and so is "off": the reference's XLA stack runs one
    gated layer after another and sums the skips in the compute dtype, as
    "layer" does, on kernel 5's "layer" epilogue (which keeps the biases
    and the gate pre-activation in fp32 where the XLA form rounds them to
    the compute dtype).  A stack with a dilation above the reference's time
    tile (TIME_TILE = 512) is "layer" whatever the flag: the reference runs
    it (`tile_ok` false) on that XLA per-layer form, and kernel 5's "layer"
    epilogue reads the tap at any distance."""
    modes = {"auto": auto, "mega": "train" if auto == "train" else "infer",
             "mega_train": "train", "mega_dx": "dx", "on": "layer",
             "off": "layer", **{m: m for m in STACK_MODES}}
    if flag not in modes:
        raise NotImplementedError(
            f"fused_layers={flag!r} is not ported (the port's stack modes "
            f"are {sorted(STACK_MODES)})")
    if dilations and max(dilations) > TIME_TILE:
        return "layer"
    return modes[flag]


def match_length(cond: torch.Tensor, T: int) -> torch.Tensor:
    """Crop, or edge-pad, upsampled conditioning (B, Tc, M) to T samples."""
    Tc = cond.shape[1]
    if Tc >= T:
        return cond[:, :T]
    edge = cond[:, -1:].expand(-1, T - Tc, -1)
    return torch.cat([cond, edge], dim=1)


def shift_right_scalar(x: torch.Tensor) -> torch.Tensor:
    """(B, T) waveform -> (B, T, 1) of previous samples (the AR input)."""
    return shift_right(x[..., None], 1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# flax's variance_scaling(1.0, "fan_in", "truncated_normal"): the normal
# truncated at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def fan_in_init_(t: torch.Tensor, fan_in: int,
                 generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device))


class CausalConv1d(nn.Module):
    """1x1 conv with kernel (1, Cin, Cout): the stack's front and heads (the
    dilated K=2 convs live inside the stack)."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(1, in_channels, features, device=device)
        self.bias = _param(features, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in_init_(self.kernel, self.kernel.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return causal_conv1d(x.to(dt), self.kernel.to(dt), 1,
                             self.bias.to(dt))


# a layer's parameters in `fused_gated_residual`'s argument order
_LAYER_PARAMS = ("w_dilated", "b_dilated", "w_cond", "b_cond", "w_res",
                 "b_res", "w_skip", "b_skip")


class GatedLayer(nn.Module):
    """Parameters of one gated residual layer:
        w_dilated (2, C, G), b_dilated, w_cond (M, G), b_cond,
        w_res (G/2, C), b_res, w_skip (G/2, S), b_skip
    The compute lives in the stack (`ops/flow_stack.py`,
    `ops/gated_layer.py`)."""

    def __init__(self, residual_channels: int, gate_channels: int,
                 skip_channels: int, cond_channels: int, device=None):
        super().__init__()
        C, G, S, M = (residual_channels, gate_channels, skip_channels,
                      cond_channels)
        self.w_dilated = _param(2, C, G, device=device)
        self.b_dilated = _param(G, device=device)
        self.w_cond = _param(M, G, device=device)
        self.b_cond = _param(G, device=device)
        self.w_res = _param(G // 2, C, device=device)
        self.b_res = _param(C, device=device)
        self.w_skip = _param(G // 2, S, device=device)
        self.b_skip = _param(S, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in_init_(self.w_dilated, 2 * self.w_dilated.shape[1], generator)
        fan_in_init_(self.w_cond, self.w_cond.shape[0], generator)
        fan_in_init_(self.w_res, self.w_res.shape[0], generator)
        fan_in_init_(self.w_skip, self.w_skip.shape[0], generator)
        for b in (self.b_dilated, self.b_cond, self.b_res, self.b_skip):
            nn.init.zeros_(b)


class WaveNetStack(nn.Module):
    """Front 1x1 -> dilated gated layers (skip sum) -> relu/1x1/relu/1x1.

    The trunk of the teacher (out_dim = the head's width) and of each
    student IAF flow (out_dim = 2: mu, log_s).  In the modes of `STACK_FNS`
    the gated layers run as one call of the mode's stack function over the
    stacked layout of `stacked()`; in "layer" they run one by one through
    `FusedGatedResidual` over the per-layer layout of `layer_weights()`.
    The mode is fixed when the model is built, and kept at every width.
    The reference's `mega_ok` keeps every preset's stack on its whole-stack
    kernels, but at the wide teacher's widths (256, 512, 256, 80) its
    `mega_fits_vmem` fails (28.4 MB at 24 layers in bf16, against a 12 MB
    VMEM budget) and it runs per layer, summing the skip in the compute
    dtype; the port keeps "infer", "train" and "dx" there on purpose (the
    budget is a TPU fact, and the skip sum stays fp32:
    `tests/test_torch_wide.py::
    test_wide_stack_keeps_its_mode_against_the_per_layer_form` states the
    gap):
    - "infer": `flow_stack` picks kernel 1 or kernel 5's accumulate loop on
      the card;
    - "train" and "dx": kernels 2 and 3;
    - "layer" where the config asks for it ("on", "layer", "off"), and
      only "layer" for a stack with a dilation above TIME_TILE (the mode
      `resolve_stack_mode` gives it; another raises ValueError).
    Kernels 5 and 3 (and so 2) run bf16 at student_iaf's, teacher_lj's
    and the wide teacher's widths (`ops/flow_stack.py::TRAIN_KERNEL_DIMS`)
    on their wgmma bodies,
    and every other width and fp32 (the 40-mel tiny configs, any preset
    with compute_dtype float32) on their general bodies
    (`ops/flow_stack.py::kernel_body`), which read the weights packed
    once per stack (`generic_weights()`); kernel 1 is bf16 at student_iaf's
    widths only.  On the CPU every mode runs the plain versions.
    """

    def __init__(self, dilations: Sequence[int], residual_channels: int,
                 gate_channels: int, skip_channels: int, out_dim: int,
                 cond_channels: int, dtype: torch.dtype = torch.float32,
                 mode: str = "infer", device=None):
        super().__init__()
        if mode not in STACK_MODES:
            raise ValueError(
                f"stack mode {mode!r}; one of {sorted(STACK_MODES)}")
        C, S = residual_channels, skip_channels
        self.dilations = tuple(dilations)
        if mode != "layer" and max(self.dilations) > TIME_TILE:
            raise ValueError(
                f"stack mode {mode!r} with a dilation above {TIME_TILE}: "
                "such a stack runs \"layer\" (resolve_stack_mode)")
        self.dtype = dtype
        self.mode = mode
        self.skip_channels = S
        self.widths = (C, gate_channels, S, cond_channels)
        self.front = CausalConv1d(1, C, dtype=dtype, device=device)
        for i in range(len(self.dilations)):
            self.add_module(f"layer_{i}", GatedLayer(
                C, gate_channels, S, cond_channels, device=device))
        self.head1 = CausalConv1d(S, S, dtype=dtype, device=device)
        self.head2 = CausalConv1d(S, out_dim, dtype=dtype, device=device)
        self._cache: dict = {}

    @property
    def layers(self) -> list:
        return [getattr(self, f"layer_{i}")
                for i in range(len(self.dilations))]

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.front.reset_parameters(generator)
        for lp in self.layers:
            lp.reset_parameters(generator)
        self.head1.reset_parameters(generator)
        self.head2.reset_parameters(generator)

    def _cached(self, name: str, build):
        """`build()`, kept while grad is off and reused until a layer
        parameter moves or changes in place (its `_version` counts that;
        writes through `.data` bypass it)."""
        params = [p for lp in self.layers for p in lp.parameters()]
        key = tuple((p.data_ptr(), p._version) for p in params)
        hit = self._cache.get(name)
        if not torch.is_grad_enabled() and hit is not None and hit[0] == key:
            return hit[1]
        out = build()
        if not torch.is_grad_enabled():
            self._cache[name] = (key, out)
        return out

    def stacked(self):
        """(w_in, b_g, w_out, b_rs) in the layout `flow_stack` reads, each
        weight stored (out, in) like `nn.Linear.weight`:
        w_in (L, G, 2C+M) = [w_dilated[1]; w_dilated[0]; w_cond] transposed
        and w_out (L, C+S, G/2) = [w_res | w_skip] transposed, in the
        compute dtype; the biases rounded to the compute dtype, then held in
        float32.  Built once while grad is off (`_cached`)."""
        return self._cached("stacked", self._build_stacked)

    def _build_stacked(self):
        dt = self.dtype

        def stk(name):
            return torch.stack([getattr(lp, name) for lp in self.layers])

        w_dil = stk("w_dilated")
        w_in = torch.cat([w_dil[:, 1], w_dil[:, 0], stk("w_cond")],
                         dim=1).to(dt)
        b_g = (stk("b_dilated") + stk("b_cond")).to(dt).float()
        w_out = torch.cat([stk("w_res"), stk("w_skip")], dim=2).to(dt)
        b_rs = torch.cat([stk("b_res").to(dt), stk("b_skip").to(dt)],
                         dim=1).float()
        return (w_in.transpose(1, 2).contiguous(), b_g.contiguous(),
                w_out.transpose(1, 2).contiguous(), b_rs.contiguous())

    def layer_weights(self) -> list:
        """Each layer's (w_in, b_g, w_out, b_out) in the layout `gated_layer`
        reads (`pack_layer`: the weights in the compute dtype, the biases
        float32 and unrounded, as the reference's per-layer kernel takes
        them).  Built without grad (the layer's backward differentiates the
        raw parameters), once while grad is off (`_cached`)."""
        def build():
            with torch.no_grad():
                return [pack_layer(*(getattr(lp, n) for n in _LAYER_PARAMS),
                                   self.dtype) for lp in self.layers]

        return self._cached("layer", build)

    def generic_weights(self):
        """`stacked()`'s weights packed for the general bodies of kernels 5
        and 3 (`ops/flow_stack.py::pack_generic`: fp32, k-major, padded,
        tanh columns beside their sigmoid partners).  Built once while grad
        is off (`_cached`), so an inference stack packs once and an
        optimizer step (an in-place change) packs anew."""
        def build():
            w_in, _, w_out, _ = self.stacked()
            return pack_generic(w_in, w_out)

        return self._cached("generic", build)

    def _generic_for(self, x: torch.Tensor):
        """`generic_weights()` where the stack function runs the general
        body on x (a CUDA tensor, `kernel_body` "generic"), else None."""
        if x.is_cuda and kernel_body(self.dtype, *self.widths) == "generic":
            return self.generic_weights()
        return None

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        x = self.front(x).contiguous()
        cond = cond.to(self.dtype).contiguous()
        if self.mode == "layer":
            # the reference's per-layer path: skip summed in the compute
            # dtype, layer by layer
            skip = torch.zeros(x.shape[:-1] + (self.skip_channels,),
                               dtype=self.dtype, device=x.device)
            for lp, d, packed in zip(self.layers, self.dilations,
                                     self.layer_weights()):
                x, s = FusedGatedResidual.apply(
                    x, cond, *(getattr(lp, n) for n in _LAYER_PARAMS), d,
                    packed)
                skip = skip + s
        else:
            skip = STACK_FNS[self.mode](x, cond, *self.stacked(),
                                        dilations=self.dilations,
                                        packed=self._generic_for(x))
        h = F.relu(skip)
        h = F.relu(self.head1(h))
        return self.head2(h).float()


class UpsampleNet(nn.Module):
    """Mel-frame -> sample-rate conditioning: transposed convs, each followed
    by leaky_relu(0.4); the product of `strides` is the hop length, so
    (B, F, n_mels) -> (B, F*hop, n_mels).  With `weight_norm` each kernel is
    `ops/norm.py::weight_norm(v_i, g_i)`, held as `v_{i}` and `g_{i}` in
    place of `kernel_{i}` (the reference's names)."""

    def __init__(self, strides: Sequence[int], channels: int,
                 in_channels: int, kernel_mult: int = 2,
                 dtype: torch.dtype = torch.float32, weight_norm: bool = False,
                 device=None):
        super().__init__()
        self.strides = tuple(strides)
        self.dtype = dtype
        self.weight_norm = weight_norm
        cin = in_channels
        for i, stride in enumerate(self.strides):
            shape = (stride * kernel_mult, cin, channels)
            if weight_norm:
                self.register_parameter(f"v_{i}", _param(*shape,
                                                         device=device))
                self.register_parameter(f"g_{i}", _param(channels,
                                                         device=device))
            else:
                self.register_parameter(f"kernel_{i}", _param(
                    *shape, device=device))
            self.register_parameter(f"bias_{i}", _param(channels,
                                                        device=device))
            cin = channels

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(len(self.strides)):
            k = getattr(self, f"v_{i}" if self.weight_norm else f"kernel_{i}")
            fan_in_init_(k, k.shape[0] * k.shape[1], generator)
            if self.weight_norm:
                init_weight_norm_(k, getattr(self, f"g_{i}"))
            nn.init.zeros_(getattr(self, f"bias_{i}"))

    def kernel(self, i: int) -> torch.Tensor:
        """The i-th transposed conv's kernel (K, Cin, Cout) in float32."""
        if self.weight_norm:
            return weight_norm(getattr(self, f"v_{i}"),
                               getattr(self, f"g_{i}"))
        return getattr(self, f"kernel_{i}")

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = mel.to(dt)
        for i, stride in enumerate(self.strides):
            x = conv_transpose1d(x, self.kernel(i).to(dt), stride,
                                 getattr(self, f"bias_{i}").to(dt))
            x = F.leaky_relu(x, 0.4)
        return x
