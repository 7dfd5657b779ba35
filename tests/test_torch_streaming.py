"""The port's streaming synthesis (`pwn_tpu_torch/generate.py`) and the rest
of its DSP (`pwn_tpu_torch/utils/dsp.py`) against the JAX reference.

Streaming recomputes each chunk with the flows' receptive field before it,
so the concatenated chunks equal the whole call on the same noise
(`tests/test_streaming.py` for the reference).  The one-window function
the direct stream and the server's batch engine share is held against
JAX's `_stream_window_fn` row by row; torch's random numbers are not
jax.random's, so the noise is passed explicitly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwn_tpu import generate as jgen
from pwn_tpu.utils import dsp as jdsp
from pwn_tpu_torch import get_config, override
from pwn_tpu_torch import generate as gen
from pwn_tpu_torch.models.student import StudentIAF
from pwn_tpu_torch.utils import dsp
from torch_parity import SMALL_STUDENT, jax_config, paired_students

CFG = get_config("tiny_teacher", **SMALL_STUDENT)
HOP = CFG.dsp.hop_length
M = CFG.dsp.n_mels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it, so these tests run
    torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return paired_students(CFG)


def _whole(port, z, mel):
    with torch.inference_mode():
        return port.generate_from_z(torch.as_tensor(z),
                                    torch.as_tensor(mel)).numpy()


def _inputs(rng, B, F):
    mel = rng.uniform(0, 1, (B, F, M)).astype(np.float32)
    z = rng.logistic(0, 1, (B, F * HOP)).astype(np.float32)
    return mel, z


@pytest.mark.parametrize("F,chunk_frames,B", [(64, 16, 1), (60, 10, 2)])
def test_stream_matches_whole_call(models, F, chunk_frames, B):
    """rtol 1e-5, atol 1e-6, the reference's own bound
    (tests/test_streaming.py): the same float32 math over other shapes."""
    _, _, port = models
    mel, z = _inputs(np.random.default_rng(F), B, F)
    chunks = list(gen.stream_student_chunks(CFG, port, mel, z=z,
                                            chunk_frames=chunk_frames))
    assert len(chunks) == F // chunk_frames
    assert all(c.shape == (B, chunk_frames * HOP) for c in chunks)
    np.testing.assert_allclose(np.concatenate(chunks, 1),
                               _whole(port, z, mel), rtol=1e-5, atol=1e-6)


def test_stream_matches_whole_call_gaussian():
    """The Gaussian (ClariNet) base: the window is family-agnostic, and the
    seeded block stream draws N(0, 1)."""
    cfg = CFG
    for k, v in (("teacher.output", "gaussian"), ("student.base", "gaussian")):
        cfg = override(cfg, k, v)
    port = StudentIAF(cfg)
    port.reset_parameters(torch.Generator().manual_seed(0))
    port.eval()
    rng = np.random.default_rng(3)
    mel = rng.uniform(0, 1, (2, 64, M)).astype(np.float32)
    z = rng.standard_normal((2, 64 * HOP)).astype(np.float32)
    streamed = np.concatenate(list(gen.stream_student_chunks(
        cfg, port, mel, z=z, chunk_frames=16)), 1)
    np.testing.assert_allclose(streamed, _whole(port, z, mel), rtol=1e-5,
                               atol=1e-6)
    blocks = gen.BlockNoise(cfg, 7, 16 * HOP, 2, 1.0, "cpu").window(0, 64 * HOP)
    ref = np.concatenate([
        torch.randn((2, 16 * HOP), generator=gen.item_generator(7, b, "cpu"))
        for b in range(4)], 1)
    np.testing.assert_array_equal(blocks.numpy(), ref)
    a = np.concatenate(list(gen.stream_student_chunks(
        cfg, port, mel, seed=7, chunk_frames=16)), 1)
    assert np.isfinite(a).all() and np.abs(a).max() <= 1.0


def test_stream_cover_tail_matches_whole_call(models):
    """cover_tail emits a final partial chunk, and the whole utterance
    still equals the whole call; with F % chunk == 0 it changes nothing."""
    _, _, port = models
    rng = np.random.default_rng(4)
    mel, z = _inputs(rng, 2, 61)  # 61 = 3 x 16 + 13
    chunks = list(gen.stream_student_chunks(CFG, port, mel, z=z,
                                            chunk_frames=16, cover_tail=True))
    assert chunks[-1].shape == (2, 13 * HOP)
    streamed = np.concatenate(chunks, 1)
    assert streamed.shape == (2, 61 * HOP)
    np.testing.assert_allclose(streamed, _whole(port, z, mel), rtol=1e-5,
                               atol=1e-6)
    mel, z = _inputs(rng, 2, 64)
    a = list(gen.stream_student_chunks(CFG, port, mel, z=z, chunk_frames=16,
                                       cover_tail=True))
    b = list(gen.stream_student_chunks(CFG, port, mel, z=z, chunk_frames=16))
    assert len(a) == len(b) == 4
    np.testing.assert_array_equal(np.concatenate(a, 1), np.concatenate(b, 1))


def test_stream_window_matches_jax_row_by_row(models):
    """Three rows at three window phases of one 61-frame plan (the first
    window, a middle one, the partial tail's) in one call of the port's
    window, each against JAX's `_stream_window_fn` on the same z and mel
    windows.  Tolerance 2e-4, as for the port's whole call against JAX
    (tests/test_torch_generate.py): float32 reordering through the flows'
    exp(log_s) on jittered weights."""
    model, params, port = models
    cf, F = 8, 61
    rng = np.random.default_rng(5)
    mel, z = _inputs(rng, 1, F)
    _, _, CT, WT, WF = gen._stream_geometry(CFG, cf)
    plan = list(gen._stream_plan(CFG, F, cf, True))
    assert plan[-1][4] > 0 and len({p[2] for p in plan}) > 1
    picks = [plan[0], plan[len(plan) // 2], plan[-1]]
    z_win = np.concatenate([z[:, ws: ws + WT] for ws, *_ in picks])
    mel_win = np.concatenate([mel[:, f: f + WF] for _, f, *_ in picks])
    got = gen.stream_window(CFG, port, torch.from_numpy(z_win), mel_win,
                            [p[2] for p in picks],
                            [p[3] for p in picks]).numpy()
    assert got.shape == (3, CT)
    fn = jgen._stream_window_fn(jax_config(override(
        CFG, "student.fused_layers", "off")), cf)
    for i, (ws, f_start, off, out_off, _) in enumerate(picks):
        want = np.asarray(fn(params, jnp.asarray(z_win[i: i + 1]),
                             jnp.asarray(mel_win[i: i + 1]), jnp.int32(off),
                             jnp.int32(out_off)))[0]
        np.testing.assert_allclose(got[i], want, rtol=2e-4, atol=2e-4,
                                   err_msg=f"row {i} (window at {ws})")


def test_stream_plan_matches_jax():
    jcfg = jax_config(CFG)
    for F in (52, 53, 60, 64, 97, 130):
        for cf in (1, 4, 8, 13, 16, 52):
            for tail in (False, True):
                want = list(jgen._stream_plan(jcfg, F, cf, tail))
                assert list(gen._stream_plan(CFG, F, cf, tail)) == want
    assert gen._stream_geometry(CFG, 8) == jgen._stream_geometry(jcfg, 8)


@pytest.mark.parametrize("F,cf,kw,match", [
    (64, 31, {"seed": 0}, "divisible"),
    (16, 16, {"seed": 0}, "shorter than one"),
    (64, 16, {}, "or z="),
])
def test_stream_validation_errors_match_jax(models, F, cf, kw, match):
    model, params, port = models
    mel = np.zeros((1, F, M), np.float32)
    with pytest.raises(ValueError, match=match):
        next(gen.stream_student_chunks(CFG, port, mel, chunk_frames=cf, **kw))
    jkw = {"key": jax.random.PRNGKey(0)} if kw else {}
    with pytest.raises(ValueError, match=match):
        next(jgen.stream_student_chunks(jax_config(CFG), params, mel,
                                        chunk_frames=cf, **jkw))


def test_block_noise_is_deterministic_and_route_independent(models):
    """A request's noise is its block stream whatever reads it: windows
    at any phase read the same values, the seeded stream is the stream on
    z = that block stream, and another seed gives other noise."""
    _, _, port = models
    CT = 8 * HOP
    a = gen.BlockNoise(CFG, 11, CT, 1, 0.7, "cpu")
    b = gen.BlockNoise(CFG, 11, CT, 1, 0.7, "cpu")
    whole = a.window(0, 8 * CT)
    for ws in (0, 100, CT, 3 * CT - 5):
        np.testing.assert_array_equal(b.window(ws, 2 * CT),
                                      whole[:, ws: ws + 2 * CT])
    assert len(b.blocks) <= 3  # blocks behind the window are dropped
    np.testing.assert_array_equal(
        whole[:, :CT], gen.sample_base_noise(
            CFG, gen.item_generator(11, 0, "cpu"), (1, CT)) * 0.7)
    other = gen.BlockNoise(CFG, 12, CT, 1, 0.7, "cpu").window(0, CT)
    assert not torch.equal(other, whole[:, :CT])
    mel = np.random.default_rng(6).uniform(0, 1, (1, 61, M)).astype(np.float32)
    seeded = list(gen.stream_student_chunks(CFG, port, mel, seed=11,
                                            chunk_frames=8, temperature=0.7,
                                            cover_tail=True))
    on_z = list(gen.stream_student_chunks(CFG, port, mel,
                                          z=whole[:, : 61 * HOP].numpy(),
                                          chunk_frames=8, cover_tail=True))
    np.testing.assert_array_equal(np.concatenate(seeded, 1),
                                  np.concatenate(on_z, 1))


def test_mel_from_wav_host_matches_jax_and_the_torch_pipeline():
    """The host numpy mels equal the reference's (the same numpy code), and
    the torch pipeline within the reference's tolerance between its two
    pipelines (tests/test_dsp.py)."""
    rng = np.random.default_rng(7)
    wav = (rng.standard_normal(4000) * 0.3).astype(np.float32)
    host = gen.mel_from_wav_host(CFG, wav)
    np.testing.assert_array_equal(host, jgen.mel_from_wav_host(
        jax_config(CFG), wav))
    assert host.shape == (4000 // HOP, M)
    np.testing.assert_allclose(
        host, gen.mel_from_wav(CFG, wav, device="cpu")[0].numpy(), rtol=1e-4,
        atol=2e-5)
    x = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
    got = dsp.mel_spectrogram_np(x, CFG.dsp)
    np.testing.assert_array_equal(got, jdsp.mel_spectrogram_np(
        x, jax_config(CFG).dsp))
    np.testing.assert_allclose(got, dsp.mel_spectrogram(
        torch.from_numpy(x), CFG.dsp).numpy(), rtol=1e-4, atol=2e-5)


# (port function, JAX function, input kind): the rest of utils/dsp.py
DSP_CASES = {
    "amp_to_db": ("amp", False), "db_to_amp": ("db", False),
    "denormalize_db": ("norm", True), "linear_spectrogram": ("wav", True),
    "wav_to_mel": ("wav", True), "power_spectrum": ("wav", True),
    "mulaw_encode": ("wav", False), "mulaw_decode": ("wav", False),
    "mulaw_quantize": ("wav", False), "mulaw_dequantize": ("classes", False),
}


@pytest.mark.parametrize("name", sorted(DSP_CASES))
def test_dsp_matches_jax(name):
    """float32 both sides: 1e-5 relative (the log and power ulps), exact
    for the mu-law classes but at a rounding boundary."""
    kind, takes_cfg = DSP_CASES[name]
    rng = np.random.default_rng(8)
    x = {"amp": rng.uniform(0, 2, (3, 50)) * rng.integers(0, 2, (3, 50)),
         "db": rng.uniform(-100, 20, (3, 50)),
         "norm": rng.uniform(-0.2, 1.2, (3, 50)),
         "wav": np.clip(rng.standard_normal((2, 3000)) * 0.3, -1, 1),
         "classes": rng.integers(0, 256, (3, 50))}[kind]
    x = x.astype(np.int32 if kind == "classes" else np.float32)
    args = (jax_config(CFG).dsp,) if takes_cfg else ()
    want = np.asarray(getattr(jdsp, name)(jnp.asarray(x), *args))
    got = getattr(dsp, name)(torch.from_numpy(x),
                             *((CFG.dsp,) if takes_cfg else ())).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "mulaw_quantize":
        assert np.abs(got - want).max() <= 1 and (got != want).mean() < 0.01
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_griffin_lim_matches_jax():
    """From JAX's initial phases (its PRNGKey(0) draw) through 4 iterations
    of inverse STFT and STFT; 1e-4 for float32 FFTs of two libraries."""
    t = np.arange(4000) / CFG.dsp.sample_rate
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    jd = jax_config(CFG).dsp
    mag = jdsp.stft_magnitude(jnp.asarray(x), jd.n_fft, jd.hop_length,
                              jd.win_length)
    want = np.asarray(jdsp.griffin_lim(mag, jd, length=len(x), n_iters=4))
    angles = jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                                minval=-np.pi, maxval=np.pi)
    got = dsp.griffin_lim(torch.from_numpy(np.asarray(mag)), CFG.dsp,
                          length=len(x), n_iters=4,
                          angles=torch.from_numpy(np.asarray(angles))).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    seeded = dsp.griffin_lim(torch.from_numpy(np.asarray(mag)), CFG.dsp,
                             length=len(x), n_iters=2)
    assert torch.isfinite(seeded).all()
