"""The port's generation entry points against the JAX reference.

`vocode_many` must give each item exactly the documented per-item result
(`pwn_tpu/generate.py` `vocode_many`): `generate_from_z` on the item's own
noise at its true length, deemphasized on the host.  torch's random
numbers are not jax.random's, so the noise is passed explicitly.

Its pipelined loop is also held bit for bit against the serial loop it
replaced (one group uploaded, run, read back and filtered at a time), on
the CPU and, in the `gpu` cases, on the card, where the traced call shows
each group filtered while the next one runs and no upload waiting on the
card.  The card cases import no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_generate.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.generate import (_host_deemphasis as host_deemphasis,
                                    coerce_mel, generate_student,
                                    item_generator, mel_from_wav,
                                    vocode_many)
from pwn_tpu_torch.models.student import (StudentIAF, init_student,
                                          sample_base_noise)
from pwn_tpu_torch.parallel.sp import sp_mega_geometry
from pwn_tpu_torch.utils import profiling

try:        # the reference; the machine with a card has no JAX
    import jax
    import jax.numpy as jnp

    from pwn_tpu.generate import _host_deemphasis
    from pwn_tpu.generate import coerce_mel as jax_coerce_mel
    from pwn_tpu.generate import mel_from_wav as jax_mel_from_wav
    from pwn_tpu.models.student import init_student as jax_init_student
    from torch_parity import jax_config
except ImportError:
    jax = None

ROOT = Path(__file__).resolve().parents[1]

CFG = get_config("tiny_teacher")
# the reference's XLA stack ("off"; the port has no counterpart to it)
JCFG = jax_config(override(CFG, "student.fused_layers", "off")) \
    if jax is not None else None
HOP = CFG.dsp.hop_length
# 8 frames is under W = 2H+4 = 16 (the per-item upsample path); 21 and 37
# take the bucket-padded upsample + tail splice
LENGTHS = [8, 21, 37]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it (measured ~60x slower
    than alone), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """JAX and port students sharing parameters, every parameter jittered:
    fresh inits have zero biases, which would make bucket-padded
    upsampling trivially exact and leave the tail splice untested."""
    model, variables = jax_init_student(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(99)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), variables["params"])
    port = StudentIAF(CFG)
    port.load_state_dict(convert.params_from_flax(params))
    return model, params, port


@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(5)
    mels = [rng.uniform(0, 1, (F, CFG.dsp.n_mels)).astype(np.float32)
            for F in LENGTHS]
    zs = [rng.logistic(0, 1, F * HOP).astype(np.float32) for F in LENGTHS]
    return mels, zs


def test_vocode_many_matches_jax_per_item(models, items):
    """Ragged groups of a batch of 2 over three buckets.  Tolerance 2e-4,
    the reference's own bound for this comparison
    (tests/test_streaming.py): float32 reordering through 4 flows of
    exp(log_s) and the deemphasis IIR."""
    model, params, port = models
    mels, zs = items
    outs = vocode_many(CFG, port, mels, temperature=0.9, batch_size=2,
                       bucket_frames=8, z=zs)
    for F, m, z, out in zip(LENGTHS, mels, zs, outs):
        ref = model.apply({"params": params}, jnp.asarray(z[None]) * 0.9,
                          jnp.asarray(m[None]), method="generate_from_z")
        ref = _host_deemphasis(np.asarray(ref), CFG.dsp.preemphasis)[0]
        assert out.shape == (F * HOP,)
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("noise", ["seeded", "explicit"])
def test_vocode_many_same_output_at_batch_1_and_3(models, items, noise):
    """An item's audio depends only on its mel and its noise, not on the
    batch it lands in: the noise stream is seeded by (seed, item index).
    1e-5: the same float32 math at other GEMM shapes."""
    _, _, port = models
    mels, zs = items
    z = zs if noise == "explicit" else None
    # one 40-frame bucket holds all three items: one batch of 3 vs three of 1
    one = vocode_many(CFG, port, mels, seed=3, batch_size=1,
                      bucket_frames=40, z=z)
    three = vocode_many(CFG, port, mels, seed=3, batch_size=3,
                        bucket_frames=40, z=z)
    for a, b in zip(one, three):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert np.abs(one[0]).max() > 0


def test_generate_student_matches_jax(models, items):
    model, params, port = models
    mels, zs = items
    m, z = mels[1], zs[1]
    got = generate_student(CFG, port, m[None], z=torch.from_numpy(z[None]),
                           temperature=0.7)
    ref = model.apply({"params": params}, jnp.asarray(z[None]) * 0.7,
                      jnp.asarray(m[None]), method="generate_from_z")
    ref = _host_deemphasis(np.asarray(ref), CFG.dsp.preemphasis)[0]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    seeded = generate_student(CFG, port, m[None],
                              torch.Generator().manual_seed(0))
    assert seeded.shape == (m.shape[0] * HOP,) and np.isfinite(seeded).all()


def test_mel_from_wav_matches_jax(rng):
    """Mutual tolerance of the reference's two mel pipelines
    (tests/test_dsp.py)."""
    wav = np.clip(rng.standard_normal(3000) * 0.3, -1, 1).astype(np.float32)
    got = mel_from_wav(CFG, wav, device="cpu").numpy()
    want = np.asarray(jax_mel_from_wav(JCFG, wav))
    assert got.shape == want.shape == (1, 3000 // HOP, CFG.dsp.n_mels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(10,), (2, 10, 40), (10, 39),
                                   (1, 10, 41), (1, 1, 10, 40)])
def test_coerce_mel_rejects_bad_shapes(shape):
    bad = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="mel must be"):
        coerce_mel(CFG, bad)
    with pytest.raises(ValueError, match="mel must be"):
        jax_coerce_mel(JCFG, bad)


def test_coerce_mel_accepts_and_rejects_like_jax():
    mel = np.random.default_rng(0).uniform(0, 1, (7, 40)).astype(np.float32)
    np.testing.assert_array_equal(coerce_mel(CFG, mel),
                                  jax_coerce_mel(JCFG, mel))
    np.testing.assert_array_equal(coerce_mel(CFG, torch.from_numpy(mel)),
                                  mel[None])
    mel[3, 4] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        coerce_mel(CFG, mel)


# ------------------------------------- the pipelined loop against the serial


def _jittered_student(cfg, device, jitter=0.05):
    """A port student with every parameter jittered (zero biases would
    make the tail splice trivially exact), drawn on the CPU."""
    model = init_student(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(jitter * torch.randn(p.shape, generator=gen))
    return model.to(device).eval()


@torch.inference_mode()
def _serial_vocode(cfg, model, mels, seed=0, temperature=1.0, batch_size=8,
                   bucket_frames=64, z=None):
    """`vocode_many`'s arithmetic one group at a time: upload, upsample and
    splice, run the flows, read back with a blocking copy, deemphasize."""
    device = next(model.parameters()).device
    hop = cfg.dsp.hop_length
    _, H = sp_mega_geometry(cfg)
    W, S = 2 * H + 4, (H + 2) * hop
    items = [coerce_mel(cfg, m)[0] for m in mels]
    buckets = {}
    for i, m in enumerate(items):
        buckets.setdefault(-(-len(m) // bucket_frames) * bucket_frames,
                           []).append(i)

    def up(mel):
        return model.upsample_cond(torch.as_tensor(mel, device=device))

    out = [None] * len(items)
    for fb in sorted(buckets):
        Tb = fb * hop
        for at in range(0, len(buckets[fb]), batch_size):
            group = buckets[fb][at: at + batch_size]
            rows = group + [group[-1]] * (batch_size - len(group))
            if all(len(items[i]) >= W for i in group):
                cond = up(np.stack([np.pad(items[i], ((0, fb - len(items[i])),
                                                      (0, 0))) for i in rows]))
                tails = up(np.stack([items[i][-W:] for i in rows]))
                for row, i in enumerate(rows):
                    T_i = len(items[i]) * hop
                    cond[row, T_i - S: T_i] = tails[row, -S:]
            else:
                cond = torch.cat([torch.nn.functional.pad(
                    up(items[i][None]), (0, 0, 0, Tb - len(items[i]) * hop))
                    for i in rows])
            if z is None:
                zb = torch.stack([sample_base_noise(
                    cfg, item_generator(seed, i, device), (Tb,))
                    for i in rows])
            else:
                zb = torch.stack([torch.nn.functional.pad(
                    torch.as_tensor(z[i][:Tb], device=device),
                    (0, Tb - min(len(z[i]), Tb))) for i in rows])
            wav = model.flows_from_z(zb * temperature, cond).cpu().numpy()
            wav = host_deemphasis(wav, cfg.dsp.preemphasis)
            for i, w in zip(group, wav):
                out[i] = w[:len(items[i]) * hop]
    return out


# frames of each job: one group; a ragged job over three buckets at batch 2
# (8 and 9 under W = 16 frames take the per-item upsample)
ONE_GROUP = [21, 37, 30]
RAGGED = [8, 21, 37, 20, 9, 30]
SERIAL_CASES = {
    "one_group": dict(frames=ONE_GROUP, batch_size=3, bucket_frames=40),
    "ragged": dict(frames=RAGGED, batch_size=2, bucket_frames=16),
    "explicit_z": dict(frames=RAGGED, batch_size=2, bucket_frames=16,
                       z=True),
    "no_preemphasis": dict(frames=RAGGED, batch_size=2, bucket_frames=16,
                           preemphasis=0.0),
}


@pytest.mark.parametrize("case", sorted(SERIAL_CASES))
def test_vocode_many_equals_the_serial_loop(case, monkeypatch):
    """The pipelined loop gives every item the serial loop's bits.  Without
    preemphasis no output shares memory with another output or with the
    flows' output it was read from."""
    kw = dict(SERIAL_CASES[case])
    frames = kw.pop("frames")
    cfg = override(CFG, "dsp.preemphasis", kw.pop("preemphasis", 0.97))
    model = _jittered_student(cfg, "cpu")
    rng = np.random.default_rng(7)
    mels = [rng.uniform(0, 1, (f, cfg.dsp.n_mels)).astype(np.float32)
            for f in frames]
    if kw.pop("z", False):
        kw["z"] = [rng.logistic(0, 1, f * HOP + 5).astype(np.float32)
                   for f in frames]
    want = _serial_vocode(cfg, model, mels, seed=11, temperature=0.9, **kw)
    staged = []
    flows = model.flows_from_z

    def keep(*args):
        staged.append(flows(*args))
        return staged[-1]

    monkeypatch.setattr(model, "flows_from_z", keep)
    got = vocode_many(cfg, model, mels, seed=11, temperature=0.9, **kw)
    assert len(staged) == (1 if case == "one_group" else 4)
    assert [len(g) for g in got] == [f * HOP for f in frames]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.abs(got[0]).max() > 0
    if case == "no_preemphasis":
        for a, g in enumerate(got):
            assert not any(np.shares_memory(g, t.numpy()) for t in staged)
            assert not any(np.shares_memory(g, h) for h in got[a + 1:])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 1 and the copy stream have "
                    "no CPU mode")
    return torch.device("cuda")


# student_iaf at batch 8 over three buckets of 64 frames: 64 (one ragged
# group, two items under W = 16 frames: the per-item upsample), 320 (8 + 2)
# and 448 (8 + 1)
CARD_FRAMES = [300, 9, 420, 310, 440, 50, 260, 400, 290, 410, 300, 12, 305,
               445, 315, 401, 270, 390, 280, 60, 448, 319, 385]


def _card_job(device):
    cfg = get_config("student_iaf")
    rng = np.random.default_rng(3)
    mels = [rng.uniform(0, 1, (f, cfg.dsp.n_mels)).astype(np.float32)
            for f in CARD_FRAMES]
    return cfg, _jittered_student(cfg, device), mels


def _traced_job(device):
    """One traced `vocode_many` call after a warm one: (the trace, the
    recorded spans, the number of groups)."""
    sys.path.insert(0, str(ROOT))
    from perfbench.trace import Profiler

    cfg, model, mels = _card_job(device)
    vocode_many(cfg, model, mels, seed=5)
    profiling.clear()
    prof = Profiler()
    try:
        vocode_many(cfg, model, mels, seed=5)
    finally:
        trace = prof.stop()
    rec = profiling.recorded()
    return trace, rec, sum(s.name == "vocode.cond" for s in rec.spans)


@pytest.mark.gpu
def test_vocode_many_equals_the_serial_loop_on_card(cuda):
    """At student_iaf's widths on the card the pipelined loop (pinned
    uploads, the copy stream) gives the serial loop's bits."""
    cfg, model, mels = _card_job(cuda)
    want = _serial_vocode(cfg, model, mels, seed=5)
    got = vocode_many(cfg, model, mels, seed=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.abs(got[0]).max() > 0


@pytest.mark.gpu
def test_each_deemphasis_overlaps_a_later_groups_flows_on_card(cuda):
    """Every `vocode.deemphasis` span but the last overlaps kernel 1's
    device time of a later group: the host filters while the card runs."""
    trace, rec, groups = _traced_job(cuda)
    kernels = sorted((s, e) for n, s, e in trace.device
                     if "flow_stack_kernel" in n)
    per = len(kernels) // groups
    assert groups == 5 and per and len(kernels) == per * groups
    deemph = [s for s in rec.spans if s.name == "vocode.deemphasis"]
    assert len(deemph) == groups
    for g, sp in enumerate(deemph[:-1]):
        later = kernels[(g + 1) * per:]
        assert any(s < sp.end_ns and e > sp.start_ns for s, e in later), g
    assert rec.counts["vocode.groups"] == groups
    assert rec.counts["vocode.groups_overlapped"] == groups - 1


@pytest.mark.gpu
def test_no_synchronize_between_a_groups_upload_and_launch_on_card(cuda):
    """From a group's `vocode.cond` (its first upload) to the next span
    (after its flows' launch) the host makes no synchronizing CUDA call:
    enqueueing a group never waits on the card."""
    trace, rec, groups = _traced_job(cuda)
    spans = rec.spans
    syncs = [s for n, s, _ in trace.host if "Synchronize" in n]
    copies = [s for n, s, _ in trace.host if n == "cudaMemcpyAsync"]
    conds = [k for k, s in enumerate(spans) if s.name == "vocode.cond"]
    assert len(conds) == groups and syncs
    for k in conds:
        lo, hi = spans[k].start_ns, spans[k + 1].start_ns
        assert any(lo <= s <= spans[k].end_ns for s in copies), k
        assert not [s for s in syncs if lo <= s <= hi], k
