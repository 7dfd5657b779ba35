"""The port's teacher AR sampling against the JAX reference: the weight
packing, the plain whole-loop sampler against the Pallas AR kernel in
interpret mode, the conv-queue loop against JAX's `fast_sample`, the naive
ground truth, `generate_teacher`, and (on a card) the CUDA kernel against
its plain version.

Both heads run at `tiny_teacher` widths in fp32, with parameters from JAX's
`init_teacher` through `convert.params_from_flax` and the noise stream
drawn once with numpy.  The MoL teacher has +25 on component 0's logit
bias: on a random init the logits are near-uniform, so any rounding
difference flips a Gumbel-max choice and the two trajectories part by
O(1); pinned, the comparison stays continuous.  Tolerance between two fp32
backends: 1e-4 absolute (tests/test_ar_pallas.py).

The CUDA cases are marked `gpu` and skip without a card:
    python -m pytest --noconftest -m gpu tests/test_torch_sampling.py
"""

import numpy as np
import pytest
import torch

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.generate import _host_deemphasis, generate_teacher
from pwn_tpu_torch.models import sampling
from pwn_tpu_torch.models.modules import DTYPES
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.ops import ar_sampler
from pwn_tpu_torch.ops.ar_sampler import (AR_CHUNK_ELEMS, AR_KERNEL_DIMS,
                                          AR_WIDE_DIMS, ar_sample,
                                          ar_sample_reference, chunk_geometry,
                                          pack_ar_ranks,
                                          stack_teacher_weights)
from pwn_tpu_torch.ops.mol import mol_sample_from_uniforms
from torch_parity import jax_config

TINY = get_config("tiny_teacher")
CFGS = {"mol": TINY,
        "gaussian": override(override(TINY, "teacher.output", "gaussian"),
                             "student.base", "gaussian")}
HOP = TINY.dsp.hop_length
PIN = 25.0
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    """(port config, JAX model, numpy variables, port teacher) per head,
    sharing parameters; the MoL head pinned."""
    jax = pytest.importorskip("jax")
    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher

    cfg = CFGS[request.param]
    model, variables = jax_init_teacher(jax_config(cfg), jax.random.PRNGKey(0))
    variables = jax.tree.map(np.array, variables)
    if request.param == "mol":
        variables["params"]["stack"]["head2"]["bias"][0] += PIN
    port = TeacherWaveNet(cfg)
    port.load_state_dict(convert.params_from_flax(variables))
    return cfg, model, variables, port


def _noise(cfg, rng, T, B):
    """The per-step stream of the configured head, from numpy."""
    if cfg.teacher.output == "gaussian":
        return rng.standard_normal((T, B, 1)).astype(np.float32)
    return rng.uniform(1e-5, 1 - 1e-5,
                       (T, B, cfg.teacher.n_mixtures + 1)).astype(np.float32)


def _kw(cfg, temperature=1.0):
    tc = cfg.teacher
    return dict(dilations=tc.dilations, n_mixtures=tc.n_mixtures,
                head=tc.output, log_scale_min=tc.log_scale_min,
                temperature=temperature)


def _mel(rng, B, frames):
    return rng.uniform(0, 1, (B, frames, TINY.dsp.n_mels)).astype(np.float32)


def _not_all_clipped(wav):
    """The draws must not all sit on the clip, or equality is trivial."""
    assert (np.abs(np.asarray(wav)) < 1.0).mean() > 0.2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_teacher_weights_equal_the_reference(pair, dtype):
    """The packing is the reference's exactly: weights rounded to the
    storage dtype, biases summed in fp32 and not rounded."""
    import jax.numpy as jnp

    from pwn_tpu.ops.pallas.ar_sampler import stack_teacher_weights as jax_pack

    cfg, _, variables, port = pair
    want = jax_pack(variables["params"]["stack"], cfg.teacher.n_layers,
                    dtype=jnp.dtype(dtype))
    got = stack_teacher_weights(port.stack, DTYPES[dtype])
    assert set(got) == set(want)
    for name, w in want.items():
        is_weight = name in ar_sampler._WEIGHTS
        assert got[name].dtype == (DTYPES[dtype] if is_weight
                                   else torch.float32), name
        assert got[name].is_contiguous()
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(w.astype(jnp.float32)),
                                      err_msg=name)


def test_ar_reference_matches_the_pallas_kernel(pair):
    """The plain whole-loop sampler against `ar_sample_pallas` in interpret
    mode on one cond and noise stream, B=2, T=160 (ten times the largest
    dilation)."""
    import jax.numpy as jnp

    from pwn_tpu.ops.pallas.ar_sampler import ar_sample_pallas
    from pwn_tpu.ops.pallas.ar_sampler import stack_teacher_weights as jax_pack

    cfg, _, variables, port = pair
    rng = np.random.default_rng(5)
    B, T = 2, 160
    cond = (rng.standard_normal((B, T, cfg.dsp.n_mels)) * 0.5).astype(np.float32)
    noise = _noise(cfg, rng, T, B)
    want = ar_sample_pallas(
        jnp.asarray(cond), jnp.asarray(noise),
        jax_pack(variables["params"]["stack"], cfg.teacher.n_layers,
                 dtype=jnp.float32),
        interpret=True, **_kw(cfg))
    got = ar_sample_reference(torch.from_numpy(cond), torch.from_numpy(noise),
                              stack_teacher_weights(port.stack, torch.float32),
                              **_kw(cfg))
    assert got.shape == (B, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    _not_all_clipped(want)


def test_fast_sample_matches_jax(pair):
    """The conv-queue loop from a mel (upsampler included) against JAX's
    `fast_sample(uniforms=...)` on the same stream, B=2, two frames."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.models import sampling as jax_sampling

    cfg, model, variables, port = pair
    rng = np.random.default_rng(6)
    mel = _mel(rng, 2, 2)
    noise = _noise(cfg, rng, 2 * HOP, 2)
    want = jax_sampling.fast_sample(model, variables, jax.random.PRNGKey(0),
                                    jnp.asarray(mel),
                                    uniforms=jnp.asarray(noise))
    got = sampling.fast_sample(port, None, torch.from_numpy(mel),
                               noise=torch.from_numpy(noise))
    assert got.shape == (2, 2 * HOP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    _not_all_clipped(want)
    # the whole-loop sampler (its plain version on the CPU) on that stream
    kernel_path = sampling.fast_sample_kernel(port, None, torch.from_numpy(mel),
                                              noise=torch.from_numpy(noise))
    np.testing.assert_allclose(kernel_path.numpy(), got.numpy(), rtol=0,
                               atol=TOL)


def test_naive_sample_equals_fast_sample(pair):
    """The O(T^2) ground truth (a full teacher-forcing pass per sample)
    against the conv-queue loop on one shared stream, one frame."""
    cfg, _, _, port = pair
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(_mel(rng, 2, 1))
    noise = torch.from_numpy(_noise(cfg, rng, HOP, 2))
    fast = sampling.fast_sample(port, None, mel, noise=noise)
    naive = sampling.naive_sample(port, mel, noise)
    np.testing.assert_allclose(naive.numpy(), fast.numpy(), rtol=0, atol=TOL)
    _not_all_clipped(fast)


def test_mol_sample_from_uniforms_matches_jax(rng):
    """Row 2 ties components 1 and 3 (equal logits and uniforms): both the
    reference and the port split the one-hot evenly."""
    import jax.numpy as jnp

    from pwn_tpu.models.sampling import mol_sample_from_uniforms as jax_draw

    K = 4
    params = (rng.standard_normal((5, 3 * K)) * 0.5).astype(np.float32)
    u = rng.uniform(1e-5, 1 - 1e-5, (5, K + 1)).astype(np.float32)
    params[2, :K] = [-9.0, 3.0, -9.0, 3.0]
    u[2, [1, 3]] = 0.5
    for temperature in (1.0, 0.3):
        got = mol_sample_from_uniforms(torch.from_numpy(params),
                                       torch.from_numpy(u), -7.0, temperature)
        want = jax_draw(jnp.asarray(params), jnp.asarray(u), -7.0, temperature)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    mean = 0.5 * (params[2, K + 1] + params[2, K + 3])
    log_s = 0.5 * (max(params[2, 2 * K + 1], -7.0)
                   + max(params[2, 2 * K + 3], -7.0))
    ul = u[2, K]
    tied = np.clip(mean + np.exp(log_s) * 0.3 * (np.log(ul) - np.log1p(-ul)),
                   -1, 1)
    np.testing.assert_allclose(got[2].item(), tied, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("head", sorted(CFGS))
def test_draw_noise_is_the_heads_stream(head):
    cfg = CFGS[head]
    noise = sampling.draw_noise(cfg, torch.Generator().manual_seed(0), 4000, 3)
    if head == "gaussian":
        assert noise.shape == (4000, 3, 1)
        assert abs(noise.mean().item()) < 0.05
        assert abs(noise.std().item() - 1) < 0.05
    else:
        assert noise.shape == (4000, 3, cfg.teacher.n_mixtures + 1)
        assert noise.min() >= 1e-5 and noise.max() <= 1 - 1e-5
        assert abs(noise.mean().item() - 0.5) < 0.01
    assert noise.dtype == torch.float32


def _port_teacher(cfg, seed=0):
    model = init_teacher(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    if cfg.teacher.output == "mol":
        with torch.no_grad():
            model.stack.head2.bias[0] += PIN
    return model


@pytest.mark.parametrize("backend", ["auto", "kernel", "pallas"])
def test_generate_teacher_runs_the_whole_loop_sampler(backend):
    """On a CPU model every kernel backend is `fast_sample_kernel`'s plain
    version, deemphasized on the host, row 0 returned as the reference
    does."""
    model = _port_teacher(TINY)
    mel = _mel(np.random.default_rng(8), 2, 2)
    wav = generate_teacher(TINY, model, mel, torch.Generator().manual_seed(3),
                           ar_backend=backend)
    want = sampling.fast_sample_kernel(model, torch.Generator().manual_seed(3),
                                       mel)
    assert wav.shape == (2 * HOP,) and wav.dtype == np.float32
    assert np.isfinite(wav).all()
    np.testing.assert_array_equal(
        wav, _host_deemphasis(want.numpy(), TINY.dsp.preemphasis)[0])


def test_generate_teacher_scan_backend_and_options():
    """"scan" is the eager conv-queue loop, drawing step by step from the
    generator; `ar_weights_dtype` sets the whole-loop sampler's weight
    storage (float32 is the tiny preset's own); an unknown backend
    raises."""
    model = _port_teacher(TINY)
    mel = _mel(np.random.default_rng(9), 1, 2)
    scan = generate_teacher(TINY, model, mel, torch.Generator().manual_seed(4),
                            ar_backend="scan")
    want = sampling.fast_sample(model, torch.Generator().manual_seed(4), mel)
    np.testing.assert_array_equal(
        scan, _host_deemphasis(want.numpy(), TINY.dsp.preemphasis)[0])
    pre = scan - TINY.dsp.preemphasis * np.concatenate([[0.0], scan[:-1]])
    assert np.abs(pre).max() <= 1.0 + 1e-5
    runs = {dt: generate_teacher(TINY, model, mel,
                                 torch.Generator().manual_seed(5),
                                 ar_weights_dtype=dt)
            for dt in (None, "float32", "bfloat16")}
    np.testing.assert_array_equal(runs[None], runs["float32"])
    assert not np.array_equal(runs[None], runs["bfloat16"])
    assert np.abs(runs[None] - runs["bfloat16"]).max() < 0.1
    with pytest.raises(ValueError, match="ar_backend"):
        generate_teacher(TINY, model, mel, torch.Generator(), ar_backend="xla")


def _stacked(dims, L, dtype, seed):
    """Random gate-layer weights at widths `dims` = (C, G, S, M) in
    `stack_teacher_weights`' layout, from numpy."""
    C, G, S, M = dims
    rng = np.random.default_rng(seed)

    def arr(shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    return dict(w_in=arr((L, 2 * C + M, G), (2 * C + M) ** -0.5).to(dtype),
                b_g=arr((L, G), 0.1),
                w_out=arr((L, G // 2, C + S), (G // 2) ** -0.5).to(dtype),
                b_rs=arr((L, C + S), 0.1))


def _rank_columns(G, n_ranks, j):
    """Rank j's gate columns: its tanh slice, then the sigmoid partners."""
    gn = G // 2 // n_ranks
    return [*range(j * gn, (j + 1) * gn),
            *range(G // 2 + j * gn, G // 2 + (j + 1) * gn)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", AR_KERNEL_DIMS)
@pytest.mark.parametrize("n_ranks", [8, 16])
def test_pack_ar_ranks_unpacks_to_the_stacked_layout(n_ranks, dims, dtype):
    """Each rank's run per layer is its W_in columns (tanh slice, then the
    sigmoid partners), each column's 2C+M weights contiguous, then its W_out
    rows, in the storage dtype, a multiple of 16 bytes; its gate biases
    follow the same column order.  Read back slice by slice, the runs give
    the stacked weights exactly.  At the wide widths the "chunks" layout
    (the wide kernel's) reads back exactly too, chunk by chunk as the
    kernel reads it (`_unpack_chunks`)."""
    C, G, S, M = dims
    L, kin, no, gn = 3, 2 * C + M, C + S, G // 2 // n_ranks
    w = _stacked(dims, L, DTYPES[dtype], seed=11)
    packed = pack_ar_ranks(w, n_ranks)
    assert packed["w"].shape == (n_ranks, L, kin * 2 * gn + gn * no)
    assert packed["w"].dtype == DTYPES[dtype] and packed["w"].is_contiguous()
    assert packed["w"].shape[-1] * packed["w"].element_size() % 16 == 0
    assert packed["b_g"].shape == (n_ranks, L, 2 * gn)
    assert packed["b_g"].dtype == torch.float32
    w_in, w_out = torch.zeros_like(w["w_in"]), torch.zeros_like(w["w_out"])
    b_g = torch.zeros_like(w["b_g"])
    for j in range(n_ranks):
        cols = _rank_columns(G, n_ranks, j)
        for l in range(L):
            run = packed["w"][j, l]
            w_in[l][:, cols] = run[:kin * 2 * gn].reshape(2 * gn, kin).T
            w_out[l][j * gn:(j + 1) * gn] = run[kin * 2 * gn:].reshape(gn, no)
            b_g[l][cols] = packed["b_g"][j, l]
    assert torch.equal(w_in, w["w_in"])
    assert torch.equal(w_out, w["w_out"])
    assert torch.equal(b_g, w["b_g"])
    if dims == AR_WIDE_DIMS:
        chunks = pack_ar_ranks(w, n_ranks, "chunks")
        assert chunks["w"].shape == packed["w"].shape
        assert chunks["w"].dtype == DTYPES[dtype]
        assert chunks["w"].is_contiguous()
        assert torch.equal(chunks["b_g"], packed["b_g"])
        w_in, w_out = _unpack_chunks(chunks["w"], dims, n_ranks)
        assert torch.equal(w_in, w["w_in"])
        assert torch.equal(w_out, w["w_out"])


def _unpack_chunks(run, dims, n_ranks):
    """(w_in, w_out) from `pack_ar_ranks`' "chunks" layout, read as the wide
    kernel reads it: per rank and layer the gate chunks (tap and cond rows,
    then x rows; every chunk but a last short one AR_CHUNK_ELEMS weights), then the
    W_out chunks; in a gate chunk of kc rows, lane o of the group of warp
    w's z value a reads 16 bytes (VW weights) of its tanh column (packed
    column 2 ZW w + a) and of its sigmoid partner (+ ZW) at o VW, weight e
    being row 4 (kc / VW) (e // 4) + 4 o + e % 4; in a W_out chunk thread q
    reads RV rows x its 2 outputs at (g NO/2 + q) VW."""
    C, G, S, M = dims
    NO, gn, elt = C + S, G // 2 // n_ranks, run.element_size()
    geo = chunk_geometry(C, G, S, M, n_ranks, elt)
    zw, vw, rv, zr = geo["ZW"], geo["VW"], geo["RV"], geo["ZR"]
    L = run.shape[1]
    w_in = torch.zeros((L, 2 * C + M, G), dtype=run.dtype)
    w_out = torch.zeros((L, G // 2, NO), dtype=run.dtype)
    for j in range(n_ranks):
        for l in range(L):
            flat, at = run[j, l], 0
            for k0, kc in geo["gate_chunks"]:
                chunk = flat[at:at + 2 * gn * kc].reshape(2 * gn, kc // vw, vw)
                o, e = torch.meshgrid(torch.arange(kc // vw), torch.arange(vw),
                                      indexing="ij")
                k = k0 + 4 * (kc // vw) * (e // 4) + 4 * o + e % 4
                for col in range(2 * gn):
                    w, h, a = col // (2 * zw), col % (2 * zw) // zw, col % zw
                    w_in[l, k, h * G // 2 + j * gn + w * zw + a] = chunk[col]
                at += 2 * gn * kc
                assert 2 * gn * kc <= AR_CHUNK_ELEMS
            for c in range(gn // zr):
                chunk = flat[at:at + zr * NO].reshape(zr // rv, NO // 2, rv, 2)
                for g in range(zr // rv):
                    rows = j * gn + c * zr + g * rv + torch.arange(rv)
                    w_out[l, rows] = chunk[g].permute(1, 0, 2).reshape(rv, NO)
                at += zr * NO
            assert at == flat.numel()
    return w_in, w_out


@pytest.mark.parametrize("dims", AR_KERNEL_DIMS)
@pytest.mark.parametrize("n_ranks", [8, 16])
def test_layer_from_rank_slices_equals_the_unsplit_layer(n_ranks, dims):
    """The kernel's split of one gated layer, in fp32 from the packed
    slices: per rank its gate columns and z, its partial out product; the
    residual partials summed in rank order, the skip partials kept per
    rank and summed at the end.  Against the unsplit layer within 1e-6 of
    the largest output (only the summation order differs)."""
    C, G, S, M = dims
    L, B, kin, gn = 2, 3, 2 * C + M, G // 2 // n_ranks
    w = _stacked(dims, L, torch.float32, seed=12)
    packed = pack_ar_ranks(w, n_ranks)
    rng = np.random.default_rng(13)
    x, tap, cond = (torch.from_numpy(
        (rng.standard_normal((B, n)) * 0.5).astype(np.float32))
        for n in (C, C, M))
    cat = torch.cat([x, tap, cond], dim=1)
    for l in range(L):
        g = cat @ w["w_in"][l] + w["b_g"][l]
        out = (torch.tanh(g[:, :G // 2]) * torch.sigmoid(g[:, G // 2:])
               @ w["w_out"][l] + w["b_rs"][l])
        want_res, want_skip = x + out[:, :C], out[:, C:]
        res, skips = torch.zeros((B, C)), []
        for j in range(n_ranks):
            run = packed["w"][j, l]
            gj = cat @ run[:kin * 2 * gn].reshape(2 * gn, kin).T + packed["b_g"][j, l]
            zj = torch.tanh(gj[:, :gn]) * torch.sigmoid(gj[:, gn:])
            part = zj @ run[kin * 2 * gn:].reshape(gn, C + S)
            res = res + part[:, :C]
            skips.append(part[:, C:])
        got_res = x + (w["b_rs"][l, :C] + res)
        got_skip = w["b_rs"][l, C:] + sum(skips)
        for got, want in ((got_res, want_res), (got_skip, want_skip)):
            rel = (got - want).abs().max() / want.abs().max()
            assert rel <= 1e-6, (l, float(rel))


def test_cpu_tensors_take_the_plain_version():
    """No launch is counted on the CPU: the wrapper hands a CPU tensor to
    `ar_sample_reference` and nothing else."""
    cfg = CFGS["gaussian"]
    model = _port_teacher(cfg)
    rng = np.random.default_rng(10)
    cond = torch.from_numpy(
        (rng.standard_normal((2, 40, cfg.dsp.n_mels)) * 0.5).astype(np.float32))
    noise = torch.from_numpy(_noise(cfg, rng, 40, 2))
    weights = stack_teacher_weights(model.stack, torch.float32)
    before = ar_sample.launches
    got = ar_sample(cond, noise, weights, **_kw(cfg))
    assert ar_sample.launches == before
    torch.testing.assert_close(
        got, ar_sample_reference(cond, noise, weights, **_kw(cfg)),
        rtol=0, atol=0)


# --------------------------------------------------------------------------
# on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda()


def _card_case(name, device, B, T, seed=0):
    cfg = get_config(name)
    model = _port_teacher(cfg, seed).to(device)
    tc = cfg.teacher
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cond = (torch.randn((B, T, cfg.dsp.n_mels), generator=gen, device=device)
            * 0.5).to(DTYPES[tc.compute_dtype])
    noise = sampling.draw_noise(cfg, gen, T, B)
    weights = stack_teacher_weights(model.stack, DTYPES[tc.compute_dtype])
    return cfg, cond, noise, weights


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("tiny_teacher", 2, 300),
                                      ("teacher_lj", 3, 127),
                                      ("clarinet_gaussian", 2, 300),
                                      ("teacher_lj", 1, 1)])
def test_kernel_matches_plain_on_the_card(cuda, name, B, T):
    """The CUDA kernel against `ar_sample_reference` on the same card
    tensors, per row.  Both compute in fp32 over the same stored weights;
    only summation order and libm ulps differ, but the feedback grows the
    gap with the steps (chip_smoke.py states the calibration): 1e-3 over
    the first 64 steps, 0.05 over the run.  A wrong tap or a leak is
    O(0.1)."""
    cfg, cond, noise, weights = _card_case(name, cuda, B, T)
    before = ar_sample.launches
    out = ar_sample(cond, noise, weights, **_kw(cfg))
    ref = ar_sample_reference(cond, noise, weights, **_kw(cfg))
    assert ar_sample.launches == before + 1
    assert out.shape == (B, T) and torch.isfinite(out).all()
    diff = (out - ref).abs()
    assert (diff[:, :64].amax(1) <= 1e-3).all(), diff[:, :64].amax(1)
    assert (diff.amax(1) <= 0.05).all(), diff.amax(1)


@pytest.mark.gpu
def test_kernel_rows_are_isolated(cuda):
    cfg, cond, noise, weights = _card_case("teacher_lj", cuda, 2, 300)
    a = ar_sample(cond, noise, weights, **_kw(cfg))
    cond = cond.clone()
    cond[1] += 1.0
    b = ar_sample(cond, noise, weights, **_kw(cfg))
    assert torch.equal(a[0], b[0])
    assert not torch.equal(a[1], b[1])


def _assert_kernel_matches_plain(cfg, cond, noise, weights):
    """The kernel against the plain version per row, at the gates of
    `test_kernel_matches_plain_on_the_card`."""
    out = ar_sample(cond, noise, weights, **_kw(cfg))
    ref = ar_sample_reference(cond, noise, weights, **_kw(cfg))
    assert out.shape == ref.shape and torch.isfinite(out).all()
    diff = (out - ref).abs()
    assert (diff[:, :64].amax(1) <= 1e-3).all(), diff[:, :64].amax(1)
    assert (diff.amax(1) <= 0.05).all(), diff.amax(1)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 8])
def test_kernel_matches_plain_at_each_batch(cuda, B):
    """One cluster per batch row: 1, 3 and 8 clusters at teacher_lj."""
    _assert_kernel_matches_plain(*_card_case("teacher_lj", cuda, B, 200, seed=B))


@pytest.mark.gpu
def test_kernel_matches_plain_with_fp32_weights(cuda):
    """teacher_lj with fp32-stored weights (twice the bytes per slice)."""
    cfg, cond, noise, weights = _card_case("teacher_lj", cuda, 2, 200)
    model = _port_teacher(cfg).to(cuda)
    _assert_kernel_matches_plain(
        cfg, cond, noise, stack_teacher_weights(model.stack, torch.float32))


@pytest.mark.gpu
def test_kernel_rejects_other_widths(cuda):
    """A width no built body takes runs the general body (C = 32 here,
    within the gates of the plain version); only a width past
    `generic_ar_limits` is refused, with ValueError, before any launch."""
    cfg = override(TINY, "teacher.residual_channels", 32)
    model = _port_teacher(cfg).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    cond = torch.randn((1, 200, cfg.dsp.n_mels), generator=gen,
                       device=cuda) * 0.5
    noise = sampling.draw_noise(cfg, gen, 200, 1)
    weights = stack_teacher_weights(model.stack, torch.float32)
    n = ar_sampler.ar_sample.launches_by["generic"]
    _assert_kernel_matches_plain(cfg, cond, noise, weights)
    assert ar_sampler.ar_sample.launches_by["generic"] == n + 1
    G = 240_000  # z and the tap-and-cond sums past a block's shared memory
    assert ar_sampler.generic_ar_limits(32, G, 64, 40, 30)
    big = {k: torch.zeros(v.shape[:-1] + (G,) if k in ("w_in", "b_g")
                          else (v.shape[0], G // 2, v.shape[2])
                          if k == "w_out" else v.shape,
                          dtype=v.dtype, device=cuda)
           for k, v in weights.items()}
    before = ar_sample.launches
    with pytest.raises(ValueError, match="general AR body"):
        ar_sample(cond, noise, big, **_kw(cfg))
    assert ar_sample.launches == before
