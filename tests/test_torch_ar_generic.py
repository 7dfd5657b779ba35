"""Kernel 4's general-width body (`ar_generic_kernel` in
`pwn_tpu_torch/csrc/ar_sampler.cu`): the route `ar_body` picks for every
teacher the JAX package's whole-loop sampler takes, and its limit
`generic_ar_limits`; the plain version against the JAX package's Pallas AR
kernel (interpret mode) at widths, mixture counts and depths no built body
takes; a CPU `train-teacher` whose sample dump runs at such a width; and,
on a card, the general body against its plain version and against the
built bodies.

The CPU parity cases follow `tests/test_torch_sampling.py`: parameters from
JAX's `init_teacher` through `convert.params_from_flax`, one numpy-seeded
cond and noise stream for both, the MoL head pinned (+25 on component 0's
logit bias: unpinned, a rounding difference flips a Gumbel-max choice and
the trajectories part by O(1)), the head's last 1x1 scaled by 0.1 (70
random layers' skip sum otherwise drives 87-98% of the draws onto the
clip, where equality says little), fp32, tolerance 1e-4 absolute.

The CUDA cases are marked `gpu` and skip without a card:
    python -m pytest --noconftest -m gpu tests/test_torch_ar_generic.py
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from pwn_tpu_torch import cli, convert, get_config, override
from pwn_tpu_torch.models import sampling
from pwn_tpu_torch.models.modules import DTYPES
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.ops.flow_stack import SMEM_PER_BLOCK
from pwn_tpu_torch.ops.ar_sampler import (AR_GEN_RANKS, AR_KERNEL_DIMS,
                                          AR_MAX_LAYERS, AR_MAX_MIXTURES,
                                          AR_WIDE_DIMS, ar_body, ar_geometry,
                                          ar_sample, ar_sample_reference,
                                          block_ar_smem_bytes, check_ar_args,
                                          generic_ar_limits, generic_ar_plan,
                                          generic_ar_smem_bytes, generic_tiles,
                                          head_width, pack_ar_generic,
                                          queue_offsets, stack_teacher_weights)
from pwn_tpu_torch.ops.gaussian import sample_from_normals
from pwn_tpu_torch.ops.mol import mol_sample_from_uniforms
from pwn_tpu_torch.utils.audio_io import read_wav
from torch_parity import jax_config

TINY = get_config("tiny_teacher")
# (C, G, S, M) whose one-block shared memory, with the Gaussian head
# (HD = 2), is exactly SMEM_PER_BLOCK: 1 + 2C + M + 1 + 3 + 2 + (C + 1); no
# plan of the cluster body fits there (its exchange buffer alone, 2 x 8 x
# C floats, is 1.2 MB), so the one-block body ("block") takes it
AT_SMEM_LIMIT = (19_000, 2, 1, SMEM_PER_BLOCK // 4 - 8 - 3 * 19_000)
# the CLI's unbuilt width, and one whose 45 z values do not split over the
# 8 ranks (padded to 48)
CLI_DIMS, PADDED_DIMS = (96, 192, 96, 80), (40, 90, 40, 80)
PIN = 25.0
HEAD2_SCALE = 0.1
TOL = 1e-4  # two fp32 backends (tests/test_ar_pallas.py)
# the card's gates: tests/test_torch_sampling.py::test_kernel_matches_plain_on_the_card
EARLY, TOL_EARLY, TOL_RUN = 64, 1e-3, 0.05


def _widths(C, G, S):
    return {"teacher.residual_channels": C, "teacher.gate_channels": G,
            "teacher.skip_channels": S}


# (overrides of tiny_teacher, head): widths, mixture counts and depths no
# built body takes
OFF_GRID = {
    "C=48": (_widths(48, 96, 48), "mol"),
    "C=48 gaussian": (_widths(48, 96, 48), "gaussian"),
    "C=96": (_widths(96, 192, 96), "mol"),
    "C=96 gaussian": (_widths(96, 192, 96), "gaussian"),
    "C=40, 45 z values over 8 ranks": (_widths(40, 90, 40), "mol"),
    "teacher_lj widths, M=40": (_widths(128, 256, 128), "mol"),
    "K=16": ({"teacher.n_mixtures": 16}, "mol"),
    "70 layers": ({"teacher.n_blocks": 14}, "mol"),
    "70 layers gaussian": ({"teacher.n_blocks": 14}, "gaussian"),
}


def _config(overrides: dict, head: str):
    cfg = TINY
    for k, v in overrides.items():
        cfg = override(cfg, k, v)
    if head == "gaussian":
        cfg = override(override(cfg, "teacher.output", "gaussian"),
                       "student.base", "gaussian")
    return cfg


def _dims(cfg):
    tc = cfg.teacher
    return (tc.residual_channels, tc.gate_channels, tc.skip_channels,
            cfg.dsp.n_mels)


def _kw(cfg, temperature=1.0):
    tc = cfg.teacher
    return dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures,
                head=tc.output, log_scale_min=tc.log_scale_min,
                temperature=temperature)


def _noise(cfg, rng, T, B):
    if cfg.teacher.output == "gaussian":
        return rng.standard_normal((T, B, 1)).astype(np.float32)
    return rng.uniform(1e-5, 1 - 1e-5,
                       (T, B, cfg.teacher.n_mixtures + 1)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the route


@pytest.mark.parametrize("dims,L,K,head,want", [
    ((128, 256, 128, 80), 24, 10, "mol", "slices"),
    ((64, 128, 64, 40), 10, 10, "mol", "slices"),
    ((128, 256, 128, 80), 24, 0, "gaussian", "slices"),
    (AR_WIDE_DIMS, 24, 10, "mol", "chunks"),
    ((128, 256, 128, 80), AR_MAX_LAYERS, AR_MAX_MIXTURES, "mol", "slices"),
    ((128, 256, 128, 80), 65, 10, "mol", "generic"),
    ((64, 128, 64, 40), 70, 10, "gaussian", "generic"),
    ((128, 256, 128, 80), 24, 11, "mol", "generic"),
    (AR_WIDE_DIMS, 24, 16, "mol", "generic"),
    ((128, 256, 128, 40), 24, 10, "mol", "generic"),
    ((96, 192, 96, 80), 24, 10, "mol", "generic"),
    ((48, 96, 48, 40), 10, 10, "gaussian", "generic"),
    ((5, 34, 3, 7), 3, 1, "mol", "generic"),
    ((128, 60_000, 128, 80), 24, 10, "mol", "generic"),
    (AT_SMEM_LIMIT, 2, 0, "gaussian", "block"),
])
def test_ar_body_routes_by_widths_layers_and_mixtures(dims, L, K, head, want):
    """The built widths keep their bodies within AR_MAX_LAYERS layers and
    AR_MAX_MIXTURES mixtures (any for the Gaussian head); every other
    teacher goes to the general cluster body, or, where no plan of it fits
    a block (max(C, S) past ~3,400), to the one-block body."""
    assert ar_body(*dims, L, K, head) == want


@pytest.mark.parametrize("dims,K,head", [
    ((128, 256, 128, 80), 0, "mol"),       # no mixture
    ((128, 255, 128, 80), 10, "mol"),      # odd G
    ((128, 600_000, 128, 80), 10, "mol"),  # past the shared memory
    ((128, 256, 128, 80), 20_000, "mol"),  # a head past it
])
def test_past_generic_ar_limits_raises(dims, K, head):
    """Past `generic_ar_limits` no body takes the call: ValueError naming
    the limit, the same on the CPU as on a card."""
    assert generic_ar_limits(*dims, head_width(K, head)) is not None
    with pytest.raises(ValueError, match="general AR body"):
        ar_body(*dims, 24, K, head)


def test_generic_ar_smem_counts_the_floats():
    """The cluster body at the CLI's (96, 192, 96, 80), 24 layers, K = 10,
    bf16: the barriers 144 B; fp32 the exchange 2 x 8 x 96, x 96, cond 80,
    the tap-and-cond sums 2 x 12, z 2 x 12, skip partials, bias sums,
    relu(skip) and hidden 4 x 96, the head's output 32 (30 rounded to 4),
    the fed-back sample 4; the taps 24 x 96 floats, the head's weights 96 x
    126 bf16, each layer's dilation, offset and slots 4 ints, 4 stages of
    a whole layer (8,832 weights).  The one-block
    body holds the fed-back sample, [x | tap | cond] 336, z 128, skip and
    the head's two S-vectors 384, the output 30 and 4,096 floats of
    partials at teacher_lj's widths; all of it dynamic, so widths of
    exactly SMEM_PER_BLOCK bytes pass the limit there."""
    plan = generic_ar_plan(*CLI_DIMS, 30, 24, 2)
    assert (plan["gn"], plan["whole"], plan["ue"], plan["stages"],
            plan["taps"], plan["head"]) == (12, 1, 8832, 4, 1, 1)
    assert generic_ar_smem_bytes(*CLI_DIMS, 30, 24, 2) == (
        144 + 4 * (2 * 8 * 96 + 96 + 80 + 24 + 2 * 12 + 4 * 96 + 32 + 4)
        + 4 * 24 * 96 + 16 * 24 + 2 * 96 * 126 + 4 * 8832 * 2) == 113_312
    assert block_ar_smem_bytes(128, 256, 128, 80, 30) == 4 * (
        1 + 336 + 128 + 384 + 30 + 4096)
    assert block_ar_smem_bytes(256, 512, 256, 80, 30) == 4 * (
        1 + 592 + 256 + 768 + 30 + 4096)
    assert block_ar_smem_bytes(8192, 2, 1, 1, 2) == 4 * (
        1 + 16_385 + 1 + 3 + 2 + 8193)
    assert block_ar_smem_bytes(*AT_SMEM_LIMIT, 2) == SMEM_PER_BLOCK
    assert generic_ar_plan(*AT_SMEM_LIMIT, 2, 2, 4) is None
    assert generic_ar_limits(*AT_SMEM_LIMIT, 2) is None
    C, G, S, M = AT_SMEM_LIMIT
    assert generic_ar_limits(C, G, S, M + 1, 2) is not None


@pytest.mark.parametrize("dims,L,wb,whole", [
    (CLI_DIMS, 24, 2, 1), (PADDED_DIMS, 24, 2, 1), ((5, 34, 3, 7), 3, 4, 1),
    (AR_WIDE_DIMS, 24, 4, 0), ((128, 256, 128, 80), 600, 2, 1),
])
def test_generic_plan_fits_a_block(dims, L, wb, whole):
    """Every plan's shared memory is within SMEM_PER_BLOCK with a ring of 2
    to 8 stages; a layer moves whole where two stages of it fit (the wide
    teacher's 54,272 fp32 weights a rank do not: 8 KB tiles); 600 layers'
    taps (307 KB) are not held; the tiles fill their units."""
    C, G, S, M = dims
    plan = generic_ar_plan(C, G, S, M, 30, L, wb)
    assert plan["smem"] <= SMEM_PER_BLOCK and 2 <= plan["stages"] <= 8
    assert plan["whole"] == whole and plan["taps"] == (L * C * 4 < 200_000)
    sizes = [n for *_, n in generic_tiles(C, S, M, plan)]
    if whole:
        assert sum(sizes) <= plan["ue"] and plan["units"] == 1
    else:
        assert max(sizes) <= plan["ue"] and plan["units"] == len(sizes)
    assert plan["ue"] * wb % 16 == 0


def _unpack(packed: dict, plan: dict, C: int, G: int, S: int, M: int, L: int):
    """`pack_ar_generic`'s inverse: (w_in, w_out, b_g) in
    `stack_teacher_weights`' layout, and whether every padded place (z
    values past G/2, the units' tails) holds zero."""
    N, gn, ue = AR_GEN_RANKS, plan["gn"], plan["ue"]
    GH, K, NO = G // 2, 2 * C + M, C + S
    w = packed["w"].reshape(N, L, plan["units"], ue)
    win = torch.zeros(N, L, gn, 2, K, dtype=w.dtype)
    wout = torch.zeros(N, L, gn, NO, dtype=w.dtype)
    off, u, zero = 0, 0, True
    for seg, a0, na, b0, nb, n in generic_tiles(C, S, M, plan):
        flat = w[:, :, u].reshape(N, L, ue)
        t = flat[..., off:off + n]
        if seg == "out":
            wout[:, :, b0:b0 + nb, a0:a0 + na] = t.reshape(N, L, nb, na)
        else:
            t = t.reshape(N, L, na, 2, n // (2 * na))
            r0 = b0 + {"x": 0, "tap": C, "cond": 2 * C}[seg]
            win[:, :, a0:a0 + na, :, r0:r0 + nb] = t[..., :nb]
            zero &= bool((t[..., nb:] == 0).all())
        if plan["whole"]:
            off += n
        else:
            zero &= bool((flat[..., n:] == 0).all())
            u += 1
    if plan["whole"]:
        zero &= bool((w[..., 0, off:] == 0).all())
    win = win.permute(1, 4, 3, 0, 2).reshape(L, K, 2, N * gn)
    wout = wout.transpose(0, 1).reshape(L, N * gn, NO)
    bg = packed["b_g"].reshape(N, L, 2, gn).permute(1, 2, 0, 3)
    bg = bg.reshape(L, 2, N * gn)
    zero &= bool((win[..., GH:] == 0).all() and (wout[:, GH:] == 0).all()
                 and (bg[..., GH:] == 0).all())
    return (win[..., :GH].reshape(L, K, G), wout[:, :GH],
            bg[..., :GH].reshape(L, G), zero)


@pytest.mark.parametrize("dims,wdtype", [
    (CLI_DIMS, torch.bfloat16), (PADDED_DIMS, torch.bfloat16),
    (PADDED_DIMS, torch.float32), (AR_WIDE_DIMS, torch.float32)])
def test_pack_ar_generic_round_trips(dims, wdtype):
    """The cluster body's packing at the CLI's widths, at 45 z values over 8
    ranks (padded to 48) and at the wide teacher's in fp32 (8 KB tiles):
    each tile unpacked by `generic_tiles` gives back `stack_teacher_weights`'
    w_in, w_out and b_g exactly, and every padded place is zero."""
    C, G, S, M = dims
    cfg = _config({**_widths(C, G, S), "teacher.n_blocks": 1,
                   "teacher.layers_per_block": 3}, "mol")
    cfg = override(cfg, "dsp.n_mels", M)
    weights = stack_teacher_weights(
        init_teacher(cfg, torch.Generator().manual_seed(5),
                     device="cpu").stack, wdtype)
    L = cfg.teacher.n_layers
    plan = generic_ar_plan(C, G, S, M, 30, L, weights["w_in"].element_size())
    packed = pack_ar_generic(weights, plan)
    assert packed["w"].shape == (AR_GEN_RANKS, L, plan["units"] * plan["ue"])
    assert plan["gn"] == -(-G // 2 // AR_GEN_RANKS)
    win, wout, bg, zero = _unpack(packed, plan, C, G, S, M, L)
    assert torch.equal(win, weights["w_in"]) and torch.equal(
        wout, weights["w_out"]) and torch.equal(bg, weights["b_g"])
    assert zero


def _emulate_generic(cond, noise, weights, dilations, n_mixtures, head,
                     log_scale_min, plan, taps_held):
    """The cluster body's arithmetic in plain torch over its packed layout:
    per rank, the gate columns from its tiles in the kernel's walk order
    (the tap-and-cond sums, then the x sums, then the biases), its out
    partials, summed over the ranks in rank order; the queues of d + 1
    slots a layer, the tap read from slot (t + 1) % (d + 1) or, held,
    refilled a step ahead from x (d = 1) or slot (t + 2) % (d + 1)."""
    B, T, _ = cond.shape
    w = {k: v.float() for k, v in weights.items()}
    L, K, G = w["w_in"].shape
    C, S = w["front_k"].shape[-1], w["head1_k"].shape[0]
    M, NO, N = K - 2 * C, C + S, AR_GEN_RANKS
    packed = pack_ar_generic(weights, plan)
    run = packed["w"].float().reshape(N, L, plan["units"], plan["ue"])
    bgr = packed["b_g"].reshape(N, L, 2, plan["gn"])
    slots = [d + 1 for d in dilations]
    offs = queue_offsets(slots)
    queue = torch.zeros(sum(slots), B, C)
    taps = torch.zeros(L, B, C)
    x_prev = torch.zeros(B, 1)
    wav = torch.empty(T, B)
    for t in range(T):
        x = x_prev * w["front_k"] + w["front_b"]
        skip = torch.zeros(B, S)
        for l, d in enumerate(dilations):
            tap = taps[l] if taps_held else queue[offs[l] + (t + 1) % (d + 1)]
            if not taps_held or d > 1:
                queue[offs[l] + t % (d + 1)] = x
            parts = []
            for j in range(N):
                sums = {"tc": torch.zeros(B, plan["gn"], 2),
                        "x": torch.zeros(B, plan["gn"], 2)}
                part = torch.zeros(B, NO)
                z = None
                off, u = 0, 0
                for seg, a0, na, b0, nb, n in generic_tiles(C, S, M, plan):
                    if seg == "out" and z is None:
                        g = (bgr[j, l].T[None] + sums["tc"]) + sums["x"]
                        z = torch.tanh(g[..., 0]) * torch.sigmoid(g[..., 1])
                    tl = run[j, l, u, off:off + n]
                    off, u = (off + n, u) if plan["whole"] else (0, u + 1)
                    if seg == "out":
                        part[:, a0:a0 + na] += z[:, b0:b0 + nb] @ tl.reshape(
                            nb, na)
                    else:
                        src = {"tap": tap, "cond": cond[:, t].float(),
                               "x": x}[seg]
                        sums["x" if seg == "x" else "tc"][:, a0:a0 + na] += (
                            torch.einsum("bk,zhk->bzh", src[:, b0:b0 + nb],
                                         tl.reshape(na, 2, -1)[..., :nb]))
                parts.append(part)
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            if taps_held:
                taps[l] = x if d == 1 else queue[offs[l] + (t + 2) % (d + 1)]
            x = x + (w["b_rs"][l, :C] + total[:, :C])
            skip = skip + (w["b_rs"][l, C:] + total[:, C:])
        h = torch.relu(skip)
        h = torch.relu(h @ w["head1_k"] + w["head1_b"])
        p = h @ w["head2_k"] + w["head2_b"]
        x_t = (sample_from_normals(p, noise[t, :, 0], log_scale_min, 1.0)
               if head == "gaussian" else
               mol_sample_from_uniforms(p, noise[t], log_scale_min, 1.0))
        wav[t] = x_t
        x_prev = x_t[:, None]
    return wav.T


@pytest.mark.parametrize("case", ["padded, held taps", "padded, slot taps",
                                  "two passes, tiles", "gaussian, tiles"])
def test_generic_walk_matches_the_plain_version(case):
    """The cluster body's packing, tile walk, padded z values, per-rank
    partials summed in rank order and queues of d + 1 slots (held taps and
    taps read from their slots), emulated in plain torch, against
    `ar_sample_reference` in fp32: (40, 90, 40) with 45 z values over 8
    ranks in whole-layer units; (24, 640, 280) with 40 z values a rank
    (passes of 16, 16 and 8) and 304 outputs (two passes of 256) in tiles of at most
    512 weights (whose k-blocks and row blocks split every segment)."""
    if case.startswith("padded"):
        cfg = _config({**_widths(40, 90, 40), "teacher.n_blocks": 2,
                       "teacher.layers_per_block": 3}, "mol")
    else:
        cfg = _config({**_widths(24, 640, 280), "teacher.n_blocks": 1,
                       "teacher.layers_per_block": 3},
                      "gaussian" if case.startswith("gaussian") else "mol")
    tc = cfg.teacher
    C, G, S, M = _dims(cfg)
    hd = head_width(tc.n_mixtures, tc.output)
    model = init_teacher(cfg, torch.Generator().manual_seed(7), device="cpu")
    with torch.no_grad():
        model.stack.head2.kernel.mul_(HEAD2_SCALE)
        if tc.output == "mol":
            model.stack.head2.bias[0] += PIN
    weights = stack_teacher_weights(model.stack, torch.float32)
    plan = generic_ar_plan(C, G, S, M, hd, tc.n_layers, 4)
    if "tiles" in case:
        gn = plan["gn"]
        plan = {**plan, "whole": 0, "ue": 512, "kb_tc": 8, "kb_x": 8, "rb": 2}
        plan["units"] = sum(1 for _ in generic_tiles(C, S, M, plan))
        assert gn == 40 and C + S > 256
    rng = np.random.default_rng(8)
    B, T = 2, 16
    cond = torch.from_numpy((rng.standard_normal((B, T, M)) * 0.5)
                            .astype(np.float32))
    noise = torch.from_numpy(_noise(cfg, rng, T, B))
    kw = _kw(cfg)
    want = ar_sample_reference(cond, noise, weights, **kw)
    got = _emulate_generic(cond, noise, weights, tc.dilations,
                           tc.n_mixtures, tc.output, tc.log_scale_min, plan,
                           taps_held=case != "padded, slot taps")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_check_ar_args_takes_any_width_and_names_the_body():
    """The built bodies' caps apply to them alone: at (96, 192, 96, 80)
    with 70 layers and 16 mixtures the arguments pass to the device check;
    a built body asked for where `ar_body` does not pick it raises."""
    cfg = _config({**_widths(96, 192, 96), "teacher.n_blocks": 14,
                   "teacher.n_mixtures": 16}, "mol")
    cfg = override(cfg, "dsp.n_mels", 80)
    model = TeacherWaveNet(cfg)
    weights = stack_teacher_weights(model.stack, torch.bfloat16)
    tc = cfg.teacher
    assert tc.n_layers == 70 > AR_MAX_LAYERS
    cond = torch.zeros(1, 4, 80, dtype=torch.bfloat16)
    noise = torch.full((4, 1, tc.n_mixtures + 1), 0.5)
    with pytest.raises(ValueError, match="CUDA device"):
        check_ar_args(cond, noise, weights, tc.dilations, tc.n_mixtures,
                      "mol")
    for body in ("slices", "chunks"):
        with pytest.raises(ValueError, match="not built"):
            check_ar_args(cond, noise, weights, tc.dilations, tc.n_mixtures,
                          "mol", body)
    with pytest.raises(ValueError, match="body"):
        check_ar_args(cond, noise, weights, tc.dilations, tc.n_mixtures,
                      "mol", "ring")


def test_cpu_tensors_take_the_plain_version_whatever_the_body():
    """A CPU tensor reaches `ar_sample_reference` and nothing else, with
    or without `body`, and counts no launch."""
    cfg = _config(_widths(48, 96, 48), "mol")
    model = init_teacher(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    cond = torch.from_numpy(rng.standard_normal((2, 24, 40))
                            .astype(np.float32))
    noise = torch.from_numpy(_noise(cfg, rng, 24, 2))
    weights = stack_teacher_weights(model.stack, torch.float32)
    want = ar_sample_reference(cond, noise, weights, **_kw(cfg))
    before, by = ar_sample.launches, dict(ar_sample.launches_by)
    for body in (None, "generic"):
        got = ar_sample(cond, noise, weights, body=body, **_kw(cfg))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ar_sample.launches == before and dict(ar_sample.launches_by) == by


# ------------------------------------------------ against the reference


@pytest.mark.parametrize("case", sorted(OFF_GRID))
def test_ar_reference_matches_the_pallas_kernel_off_grid(case):
    """The plain whole-loop sampler against `ar_sample_pallas` in interpret
    mode, B = 2, T = 32 (twice the largest dilation), on the same cond,
    noise and converted weights, at a width, mixture count or depth no
    built body takes: what the general body computes on the card."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher
    from pwn_tpu.ops.pallas.ar_sampler import ar_sample_pallas
    from pwn_tpu.ops.pallas.ar_sampler import stack_teacher_weights as jax_pack

    cfg = _config(*OFF_GRID[case])
    tc = cfg.teacher
    dims = _dims(cfg)
    assert ar_body(*dims, tc.n_layers, tc.n_mixtures, tc.output) == "generic"
    _, variables = jax_init_teacher(jax_config(cfg), jax.random.PRNGKey(3))
    variables = jax.tree.map(np.array, variables)
    variables["params"]["stack"]["head2"]["kernel"] *= HEAD2_SCALE
    if tc.output == "mol":
        variables["params"]["stack"]["head2"]["bias"][0] += PIN
    port = TeacherWaveNet(cfg)
    port.load_state_dict(convert.params_from_flax(variables))
    rng = np.random.default_rng(6)
    B, T = 2, 32
    cond = (rng.standard_normal((B, T, dims[3])) * 0.5).astype(np.float32)
    noise = _noise(cfg, rng, T, B)
    want = ar_sample_pallas(
        jnp.asarray(cond), jnp.asarray(noise),
        jax_pack(variables["params"]["stack"], tc.n_layers,
                 dtype=jnp.float32),
        interpret=True, **_kw(cfg))
    got = ar_sample_reference(torch.from_numpy(cond), torch.from_numpy(noise),
                              stack_teacher_weights(port.stack, torch.float32),
                              **_kw(cfg))
    assert got.shape == (B, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert (np.abs(np.asarray(want)) < 1.0).mean() > 0.2


def test_cpu_train_teacher_dumps_at_an_off_grid_width(tmp_path):
    """`train-teacher` at (48, 96, 48) with 16 mixtures, one step with a
    checkpoint, so the loop's sample dump (`generate_teacher`, kernel 4's
    general body on a card) runs and writes a finite wav of the dump's
    length; then `generate --model teacher` from that workdir."""
    overrides = ["teacher.residual_channels=48", "teacher.gate_channels=96",
                 "teacher.skip_channels=48", "teacher.n_mixtures=16",
                 "teacher.n_blocks=1", "teacher.layers_per_block=3",
                 "train.global_batch_size=2", "train.crop_samples=1024",
                 "train.checkpoint_every=1", "train.eval_sample_seconds=0.02"]
    cfg = cli._load_config("tiny_teacher", overrides)
    tc = cfg.teacher
    assert ar_body(*_dims(cfg), tc.n_layers, tc.n_mixtures) == "generic"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["train-teacher", "tiny_teacher", "--workdir",
                       str(tmp_path), "--steps", "1", "--device", "cpu",
                       *overrides])
    assert rc == 0 and "teacher done: 1 steps" in out.getvalue()
    assert os.listdir(tmp_path / "samples") == ["step_00000001.wav"]
    wav, sr = read_wav(str(tmp_path / "samples" / "step_00000001.wav"))
    hop = cfg.dsp.hop_length
    n = max(hop * 4, int(0.02 * sr))
    assert sr == cfg.dsp.sample_rate and wav.shape == (n // hop * hop,)
    assert np.isfinite(wav).all()
    gen_wav = str(tmp_path / "teacher.wav")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["generate", "tiny_teacher", "--model", "teacher",
                       "--workdir", str(tmp_path), "--seconds", "0.05",
                       "--output", gen_wav, "--device", "cpu", *overrides])
    wav, _ = read_wav(gen_wav)
    assert rc == 0 and wav.shape == (int(0.05 * sr) // hop * hop,)
    assert np.isfinite(wav).all()


# --------------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda()


def _card_case(cfg, device, B, T, seed=0, wdtype=None, front=1.0,
               head2=1.0):
    """A random-init teacher on the card (MoL pinned, the front 1x1 scaled
    by `front`, the head's last by `head2`), cond in the compute dtype and
    the head's noise stream."""
    model = init_teacher(cfg, torch.Generator().manual_seed(seed),
                         device=device)
    with torch.no_grad():
        model.stack.front.kernel.mul_(front)
        model.stack.head2.kernel.mul_(head2)
        if cfg.teacher.output == "mol":
            model.stack.head2.bias[0] += PIN
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dt = DTYPES[cfg.teacher.compute_dtype]
    cond = (torch.randn((B, T, cfg.dsp.n_mels), generator=gen, device=device)
            * 0.5).to(dt)
    noise = sampling.draw_noise(cfg, gen, T, B)
    weights = stack_teacher_weights(model.stack, DTYPES[wdtype] if wdtype
                                    else dt)
    return cond, noise, weights


def _assert_rows_close(out, ref):
    """Per row: 1e-3 over the first 64 steps, 0.05 over the run (fp32 on
    both sides in another summation order, grown by the feedback)."""
    assert out.shape == ref.shape and torch.isfinite(out).all()
    diff = (out - ref).abs()
    assert (diff[:, :EARLY].amax(1) <= TOL_EARLY).all(), diff[:, :EARLY].amax(1)
    assert (diff.amax(1) <= TOL_RUN).all(), diff.amax(1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(OFF_GRID))
def test_generic_body_matches_plain_on_card(cuda, case):
    """The general body against `ar_sample_reference` on the same card
    tensors at each off-grid case, B = 2, T = 300, counted on its body."""
    cfg = _config(*OFF_GRID[case])
    cond, noise, weights = _card_case(cfg, cuda, 2, 300, head2=HEAD2_SCALE)
    n = ar_sample.launches_by["generic"]
    out = ar_sample(cond, noise, weights, **_kw(cfg))
    assert ar_sample.launches_by["generic"] == n + 1
    _assert_rows_close(out, ar_sample_reference(cond, noise, weights,
                                                **_kw(cfg)))


@pytest.mark.gpu
@pytest.mark.parametrize("name,wdtype", [("teacher_lj", None),
                                         ("teacher_lj", "float32"),
                                         ("clarinet_gaussian", None),
                                         ("tiny_teacher", None),
                                         ("wide", None), ("wide", "float32")])
def test_generic_body_matches_the_built_body_on_card(cuda, name, wdtype):
    """At the built widths `body="generic"` runs the general body on the
    same weights: within the gates of the built body and of the plain
    version.  The wide teacher's front 1x1 is scaled by 0.3, as
    chip_smoke.py's WIDE_AR_FRONT: its random-init loop is chaotic."""
    if name == "wide":
        cfg = get_config("teacher_lj")
        for k, v in _widths(*AR_WIDE_DIMS[:3]).items():
            cfg = override(cfg, k, v)
    else:
        cfg = get_config(name)
    cond, noise, weights = _card_case(cfg, cuda, 2, 300, wdtype=wdtype,
                                      front=0.3 if name == "wide" else 1.0)
    kw = _kw(cfg)
    built = ar_sample(cond, noise, weights, **kw)
    gen = ar_sample(cond, noise, weights, body="generic", **kw)
    _assert_rows_close(gen, built)
    _assert_rows_close(gen, ar_sample_reference(cond, noise, weights, **kw))


@pytest.mark.gpu
def test_generic_rows_are_isolated_on_card(cuda):
    cfg = _config(_widths(96, 192, 96), "mol")
    cond, noise, weights = _card_case(cfg, cuda, 3, 200)
    a = ar_sample(cond, noise, weights, **_kw(cfg))
    cond = cond.clone()
    cond[1] += 1.0
    b = ar_sample(cond, noise, weights, **_kw(cfg))
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_generic_batch_above_the_clusters_that_fit_on_card(cuda):
    """More rows than the card's clusters run in waves; each row is the
    same bits as when it runs alone (a cluster a row, nothing shared)."""
    cfg = _config(_widths(48, 96, 48), "mol")
    cond, noise, weights = _card_case(cfg, cuda, 1, 8)
    geo = ar_geometry(weights, n_mixtures=cfg.teacher.n_mixtures, head="mol",
                      cond_dtype=cond.dtype)
    B = geo["clusters"] + 9
    cond, noise, weights = _card_case(cfg, cuda, B, 100)
    out = ar_sample(cond, noise, weights, **_kw(cfg))
    _assert_rows_close(out, ar_sample_reference(cond, noise, weights,
                                                **_kw(cfg)))
    for r in (0, B - 1):
        one = ar_sample(cond[r:r + 1].contiguous(),
                        noise[:, r:r + 1].contiguous(), weights, **_kw(cfg))
        assert torch.equal(one[0], out[r])


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
def test_generic_geometry_on_card(cuda, wdtype):
    """The library's shared memory is `generic_ar_smem_bytes`' mirror for
    `generic_ar_plan`'s plan, one row a cluster of AR_GEN_RANKS blocks,
    the plan's stages, and the card holds a cluster at least."""
    cfg = _config({**_widths(96, 192, 96), "teacher.n_mixtures": 16}, "mol")
    weights = stack_teacher_weights(TeacherWaveNet(cfg).stack, wdtype)
    geo = ar_geometry({k: v.to(cuda) for k, v in weights.items()},
                      n_mixtures=16, head="mol", cond_dtype=torch.bfloat16)
    L, wb = cfg.teacher.n_layers, weights["w_in"].element_size()
    assert geo["body"] == "generic"
    assert (geo["rows"], geo["ranks"]) == (1, AR_GEN_RANKS)
    assert geo["smem"] == generic_ar_smem_bytes(96, 192, 96, 40, 48, L, wb)
    assert geo["stages"] == generic_ar_plan(96, 192, 96, 40, 48, L,
                                            wb)["stages"]
    assert geo["clusters"] >= 1 and "blocks" not in geo


@pytest.mark.gpu
def test_generic_body_at_the_shared_memory_limit_on_card(cuda):
    """Widths whose one-block shared memory is exactly SMEM_PER_BLOCK (the
    card's opt-in maximum), past every plan of the cluster body, run the
    one-block body and match the plain version; one mel more raises
    ValueError before any launch."""
    C, G, S, M = AT_SMEM_LIMIT
    cfg = _config({**_widths(C, G, S), "teacher.n_blocks": 1,
                   "teacher.layers_per_block": 2}, "gaussian")
    cfg = override(cfg, "dsp.n_mels", M)
    cond, noise, weights = _card_case(cfg, cuda, 1, 8, wdtype="float32")
    geo = ar_geometry(weights, n_mixtures=cfg.teacher.n_mixtures,
                      head="gaussian", cond_dtype=cond.dtype)
    assert geo["body"] == "block" and geo["smem"] == SMEM_PER_BLOCK
    n = ar_sample.launches_by["block"]
    out = ar_sample(cond, noise, weights, **_kw(cfg))
    assert ar_sample.launches_by["block"] == n + 1
    _assert_rows_close(out, ar_sample_reference(cond, noise, weights,
                                                **_kw(cfg)))
    wider = {**weights, "w_in": torch.cat(
        [weights["w_in"], weights["w_in"][:, :1]], 1)}
    cond = torch.cat([cond, cond[..., :1]], -1)
    with pytest.raises(ValueError, match="generic_ar_limits"):
        ar_sample(cond, noise, wider, **_kw(cfg))
    assert ar_sample.launches_by["block"] == n + 1


def _cluster_edge():
    """The widest C (G = 2, S = 1, M = 40, Gaussian head) with a plan of
    the cluster body."""
    lo, hi = 1, 20_000
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = ((mid, hi) if generic_ar_plan(mid, 2, 1, 40, 2, 2, 4)
                  else (lo, mid))
    return lo


def test_the_cluster_body_ends_where_its_exchange_fills_a_block():
    """Past the widest C with a cluster plan (3,380 residual channels at
    G = 2, S = 1, M = 40: the exchange buffer 2 x 8 x 3,380 floats, 216,320
    B of the block's 232,448) the route is the one-block body, picked on
    the widths alone."""
    C = _cluster_edge()
    assert C == 3380
    assert ar_body(C, 2, 1, 40, 2, 0, "gaussian") == "generic"
    assert ar_body(C + 1, 2, 1, 40, 2, 0, "gaussian") == "block"


@pytest.mark.gpu
def test_generic_body_at_the_cluster_limit_on_card(cuda):
    """At the widest C with a cluster plan the cluster body launches
    within SMEM_PER_BLOCK and matches the plain version; one residual
    channel more runs the one-block body."""
    C = _cluster_edge()
    for c, body in ((C, "generic"), (C + 1, "block")):
        cfg = _config({**_widths(c, 2, 1), "teacher.n_blocks": 1,
                       "teacher.layers_per_block": 2}, "gaussian")
        cond, noise, weights = _card_case(cfg, cuda, 1, 8, wdtype="float32")
        geo = ar_geometry(weights, n_mixtures=cfg.teacher.n_mixtures,
                          head="gaussian", cond_dtype=cond.dtype)
        assert geo["body"] == body and geo["smem"] <= SMEM_PER_BLOCK
        n = ar_sample.launches_by[body]
        out = ar_sample(cond, noise, weights, **_kw(cfg))
        assert ar_sample.launches_by[body] == n + 1
        _assert_rows_close(out, ar_sample_reference(cond, noise, weights,
                                                    **_kw(cfg)))


@pytest.mark.gpu
def test_generic_taps_from_the_queue_on_card(cuda):
    """600 layers at (96, 192, 96): their taps do not fit a block, so the
    tap products read the queue slots (d + 1 a layer); W_out scaled by
    0.2 and the head's last 1x1 by 0.1, as chip_smoke.py's case, keep the
    deep random-init loop from chaos."""
    cfg = _config({**_widths(96, 192, 96), "teacher.n_blocks": 120}, "mol")
    cond, noise, weights = _card_case(cfg, cuda, 2, 64, head2=HEAD2_SCALE)
    weights["w_out"] = (weights["w_out"] * 0.2).contiguous()
    geo = ar_geometry(weights, n_mixtures=cfg.teacher.n_mixtures, head="mol",
                      cond_dtype=cond.dtype)
    assert geo["body"] == "generic" and not geo["plan"]["taps"]
    _assert_rows_close(ar_sample(cond, noise, weights, **_kw(cfg)),
                       ar_sample_reference(cond, noise, weights, **_kw(cfg)))


@pytest.mark.gpu
@pytest.mark.parametrize("dims", AR_KERNEL_DIMS)
def test_geometry_names_the_built_body_on_card(cuda, dims):
    C, G, S, M = dims
    cfg = get_config("teacher_lj")
    for k, v in {**_widths(C, G, S), "dsp.n_mels": M}.items():
        cfg = override(cfg, k, v)
    weights = stack_teacher_weights(TeacherWaveNet(cfg).stack, torch.bfloat16)
    geo = ar_geometry({k: v.to(cuda) for k, v in weights.items()},
                      n_mixtures=10, head="mol", cond_dtype=torch.bfloat16)
    assert geo["body"] == ar_body(*dims, 24, 10)
