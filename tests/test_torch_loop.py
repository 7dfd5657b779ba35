"""The port's training loops with a workdir, on the CPU at tiny fp32 sizes:
exact resume of teacher training and of distillation (EMA and the KL
warm-up on), the workdir's files against one run of the reference's
`run_teacher_training` on the same config, a reference workdir converted
by `tools/orbax_to_torch.py` and loaded by the port, distillability-aware
teacher selection, the data engines (`train.data_engine`: each loop on a
wav dir with each engine, the stream each engine feeds, the held-out
batch against the reference's, the refusal of fault F5), and the
profiling hooks (`utils/profiling.py`).

One reference run serves the file; the port's runs share a module-scoped
teacher workdir where they can.
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scipy.io import wavfile

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.data import native_loader
from pwn_tpu_torch.data.pipeline import (WavCropDataset, corpus_split,
                                        make_train_iterator)
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.training import loop
from pwn_tpu_torch.training.teacher_select import (probe_teacher_checkpoints,
                                                   select_teacher_step)
from pwn_tpu_torch.utils import tensorboard
from pwn_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from torch_parity import jax_config

ROOT = Path(__file__).resolve().parents[1]


def _tiny(**overrides):
    """tiny_teacher's DSP (40 mels, hop 128) with a 3-layer teacher and a
    2 x 3-layer student at C=16, fp32, two 1,024-sample crops, a
    checkpoint every 2 steps, a log every step and 4-frame sample dumps."""
    cfg = get_config("tiny_teacher")
    for k, v in {
        "student.n_flows": 2, "student.layers_per_flow": 3,
        "student.residual_channels": 16, "student.gate_channels": 32,
        "student.skip_channels": 16,
        "teacher.n_blocks": 1, "teacher.layers_per_block": 3,
        "teacher.residual_channels": 16, "teacher.gate_channels": 32,
        "teacher.skip_channels": 16, "teacher.n_mixtures": 4,
        "train.global_batch_size": 2, "train.crop_samples": 1024,
        "train.checkpoint_every": 2, "train.log_every": 1,
        "train.eval_sample_seconds": 0.02, **overrides,
    }.items():
        cfg = override(cfg, k, v)
    return cfg


TEACHER = _tiny(**{"train.ema_decay": 0.5})
# student_iaf_best's recipe at the tiny widths: EMA, the KL warm-up, the
# contrastive term
DISTILL = _tiny(**{"train.ema_decay": 0.5, "distill.kl_warmup_steps": 4,
                   "distill.contrastive_weight": 0.3})
# the reference's loop shards the batch over the 8 virtual CPU devices
REF = _tiny(**{"train.global_batch_size": 8})


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
def teacher_runs(tmp_path_factory):
    """(resumed workdir, uninterrupted workdir, their RunResults): 3 steps
    then a resume to 6, and 6 steps at once, of the tiny teacher (EMA on)."""
    root = tmp_path_factory.mktemp("teacher")
    a, b = str(root / "resumed"), str(root / "whole")
    first = loop.run_teacher_training(TEACHER, a, num_steps=3, device="cpu")
    resumed = loop.run_teacher_training(TEACHER, a, num_steps=6, device="cpu")
    whole = loop.run_teacher_training(TEACHER, b, num_steps=6, device="cpu")
    return a, b, first, resumed, whole


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's `run_teacher_training` on REF: 4 steps, checkpoints
    at 2 and 4, its workdir."""
    from pwn_tpu.training.loop import run_teacher_training

    wd = str(tmp_path_factory.mktemp("reference") / "run")
    run_teacher_training(jax_config(REF), workdir=wd, num_steps=4)
    return wd


def _params(wd, tag, step):
    return torch.load(os.path.join(wd, f"ckpt_{tag}", str(step), STATE_FILE),
                      weights_only=True)


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------------------ resume


def test_teacher_resume_is_bit_identical(teacher_runs):
    """3 + 3 steps equal 6 at once: every tensor of the step-6 checkpoint
    (params, Adam's moments, the EMA), the final state and metrics."""
    a, b, first, resumed, whole = teacher_runs
    assert (first.steps_run, resumed.steps_run, whole.steps_run) == (3, 3, 6)
    assert resumed.state.step == whole.state.step == 6
    _assert_same(_params(a, "teacher", 6), _params(b, "teacher", 6))
    for k, p in resumed.state.params.items():
        assert torch.equal(p, whole.state.params[k]), k
    assert resumed.final_metrics == whole.final_metrics
    # keep_checkpoints=3: the resumed run also saved at its last step, 3
    assert CheckpointManager(os.path.join(a, "ckpt_teacher")).all_steps() == [
        3, 4, 6]
    assert CheckpointManager(os.path.join(b, "ckpt_teacher")).all_steps() == [
        2, 4, 6]


def test_distillation_resume_is_bit_identical(tmp_path):
    """Distillation with EMA, the KL warm-up and the contrastive term: 3 + 3
    steps equal 6 at once, bit for bit (the step noise and the warm-up
    read the restored step), and the student dumps land."""
    teacher = init_teacher(DISTILL, torch.Generator().manual_seed(0),
                           device="cpu").state_dict()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    r1 = loop.run_distillation(DISTILL, teacher, a, num_steps=3, device="cpu")
    r2 = loop.run_distillation(DISTILL, teacher, a, num_steps=6, device="cpu")
    whole = loop.run_distillation(DISTILL, teacher, b, num_steps=6,
                                  device="cpu")
    assert (r1.steps_run, r2.steps_run, whole.steps_run) == (3, 3, 6)
    _assert_same(_params(a, "student", 6), _params(b, "student", 6))
    assert r2.final_metrics == whole.final_metrics
    assert sorted(os.listdir(os.path.join(b, "samples"))) == [
        f"step_{s:08d}.wav" for s in (2, 4, 6)]


# --------------------------------------------------- against the reference


def _jsonl_keys(path):
    return [(r["step"], sorted(r)) for r in map(json.loads, open(path))]


def _tb_tags(tb_dir, read_events):
    (name,) = os.listdir(tb_dir)
    return [(e.get("step"), sorted(e.get("summary", {})))
            for e in read_events(os.path.join(tb_dir, name))]


def test_workdir_matches_the_reference(reference_run, tmp_path):
    """The same config through the port: the same files and directories,
    the same checkpoint steps and sample dumps, the same metric keys at the
    same steps in the jsonl, the same TB summaries at the same steps (the
    values differ: the inits differ)."""
    from pwn_tpu.utils.checkpoint import CheckpointManager as OrbaxManager
    from pwn_tpu.utils.tensorboard import read_events as ref_read_events

    wd = str(tmp_path / "run")
    res = loop.run_teacher_training(REF, wd, num_steps=4, device="cpu")
    assert res.steps_run == 4
    ref = reference_run
    assert sorted(os.listdir(wd)) == sorted(os.listdir(ref)) == [
        "ckpt_teacher", "metrics_teacher.jsonl", "samples", "tb_teacher"]
    ref_ckpt = OrbaxManager(os.path.join(ref, "ckpt_teacher"))
    assert CheckpointManager(os.path.join(wd, "ckpt_teacher")).all_steps() \
        == ref_ckpt.all_steps() == [2, 4]
    ref_ckpt.close()
    assert sorted(os.listdir(os.path.join(wd, "samples"))) == sorted(
        os.listdir(os.path.join(ref, "samples")))
    mine = _jsonl_keys(os.path.join(wd, "metrics_teacher.jsonl"))
    assert mine == _jsonl_keys(os.path.join(ref, "metrics_teacher.jsonl"))
    assert [s for s, _ in mine] == [0, 1, 2, 2, 3, 4]
    tags = _tb_tags(os.path.join(wd, "tb_teacher"), tensorboard.read_events)
    assert tags == _tb_tags(os.path.join(ref, "tb_teacher"), ref_read_events)
    assert (2, ["samples/audio"]) in tags
    audio = [e for e in tensorboard.read_events(os.path.join(
        wd, "tb_teacher", os.listdir(os.path.join(wd, "tb_teacher"))[0]))
        if "samples/audio" in e.get("summary", {})]
    a = audio[0]["summary"]["samples/audio"]
    assert a[1] == REF.dsp.sample_rate and a[4][:4] == b"RIFF"


def test_a_converted_reference_workdir_loads(reference_run, tmp_path):
    """`tools/orbax_to_torch.py` on the reference's workdir: the port's
    `load_teacher_params` equals the reference's exactly (fp32), at every
    retained step, and the port's teacher forward on them is within 1e-5
    of JAX's on the same inputs."""
    from pwn_tpu.training.loop import load_teacher_params as ref_load

    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", ROOT / "tools" / "orbax_to_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "port")
    jcfg = jax_config(REF)
    assert tool.convert_workdir(jcfg, reference_run, out) == {
        "teacher": [2, 4]}
    for step in (2, 4):
        params, got_step = loop.load_teacher_params(REF, out, step=step,
                                                    device="cpu")
        model, jparams, ref_step = ref_load(jcfg, reference_run, step=step)
        assert got_step == ref_step == step
        want = convert.params_from_flax(jax.device_get(jparams))
        _assert_same(params, want)
    flat = _params(out, "teacher", 4)
    assert flat["step"] == 4 and flat["opt.count"] == 4

    port = TeacherWaveNet(REF)
    port.load_state_dict(params)
    hop = REF.dsp.hop_length
    rng = np.random.default_rng(0)
    wav = rng.uniform(-0.8, 0.8, (2, 6 * hop)).astype(np.float32)
    mel = rng.uniform(0, 1, (2, 6, REF.dsp.n_mels)).astype(np.float32)
    want = model.apply({"params": jparams}, jnp.asarray(wav), jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(wav), torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# --------------------------------------------------------- teacher loading


def test_load_teacher_params_prefers_the_ema(teacher_runs):
    """The EMA when the checkpoint carries it and `prefer_ema`, else the
    live params; the latest step by default."""
    _, b, *_ = teacher_runs
    flat = _params(b, "teacher", 6)
    ema, step = loop.load_teacher_params(TEACHER, b, device="cpu")
    live, _ = loop.load_teacher_params(TEACHER, b, prefer_ema=False,
                                       device="cpu")
    assert step == 6 and loop.teacher_checkpoint_steps(b) == [2, 4, 6]
    for k in ema:
        assert torch.equal(ema[k], flat[f"ema.{k}"]), k
        assert torch.equal(live[k], flat[f"params.{k}"]), k
    assert any(not torch.equal(ema[k], live[k]) for k in ema)


def test_teacher_selection_picks_the_lowest_val_loss(teacher_runs):
    """`select_teacher_step` returns the probed candidate with the lowest
    val_loss (not val_kl); probing one candidate twice gives identical
    metrics (the student and its optimizer reset, the same data)."""
    _, b, *_ = teacher_runs
    results = probe_teacher_checkpoints(DISTILL, b, teacher_cfg=TEACHER,
                                        probe_steps=2, device="cpu")
    assert [r["teacher_step"] for r in results] == [2, 4, 6]
    assert all({"val_loss", "val_kl", "val_power_loss"} <= set(r)
               for r in results)
    best = min(results, key=lambda r: r["val_loss"])["teacher_step"]
    assert select_teacher_step(DISTILL, b, teacher_cfg=TEACHER, probe_steps=2,
                               device="cpu") == best
    twice = probe_teacher_checkpoints(DISTILL, b, teacher_cfg=TEACHER,
                                      probe_steps=2, candidates=[4, 4],
                                      device="cpu")
    assert twice[0] == twice[1] == results[1]


# ------------------------------------------------------------------- F5


def _run_loop(name, cfg, data_dir=None):
    if name == "teacher":
        return loop.run_teacher_training(cfg, data_dir=data_dir, num_steps=1,
                                         device="cpu")
    if name == "direct":
        return loop.run_student_direct_training(cfg, data_dir=data_dir,
                                                num_steps=1, device="cpu")
    teacher = init_teacher(cfg, torch.Generator().manual_seed(0),
                           device="cpu").state_dict()
    return loop.run_distillation(cfg, teacher, data_dir=data_dir, num_steps=1,
                                 device="cpu")


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """21 mono PCM16 clips at tiny_teacher's 16 kHz, 0.1-0.4 s: every 20th
    (2 of them) held out."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    for i in range(21):
        n = 1600 + 230 * i
        wavfile.write(str(d / f"utt_{i:02d}.wav"), 16000,
                      (rng.uniform(-0.6, 0.6, n) * 32767).astype(np.int16))
    return str(d)


@pytest.mark.parametrize("name", ["teacher", "distill", "direct"])
@pytest.mark.parametrize("engine", ["auto", "python", "native", "grain"])
def test_loops_train_on_a_wav_dir(name, engine, wav_dir, capsys):
    """Each loop on a wav dir with each engine: one step, finite metrics,
    and the engine printed once ("auto" runs the C++ loader where g++
    builds it)."""
    if engine == "grain":
        pytest.importorskip("grain")
    res = _run_loop(name, _tiny(**{"train.data_engine": engine}), wav_dir)
    assert res.steps_run == 1
    assert all(np.isfinite(v) for v in res.final_metrics.values())
    want = "native" if engine == "auto" else engine
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if "data engine" in ln]
    assert printed == [f"[{'teacher' if name == 'teacher' else 'student'}] "
                       f"data engine: {want}"]


@pytest.mark.parametrize("engine", ["auto", "python", "grain"])
def test_each_engine_feeds_its_own_stream(engine, wav_dir, tmp_path,
                                          monkeypatch):
    """The batches the teacher loop steps on, resumed at step 2 of a
    workdir, are the chosen engine's stream from step 2 over the training
    files: the C++ loader's for "auto", the Python iterator's, grain's."""
    if engine == "grain":
        pytest.importorskip("grain")
    from pwn_tpu_torch.data.grain_pipeline import make_grain_iterator

    cfg = _tiny(**{"train.data_engine": engine})
    seen = []
    prefetch = loop.prefetch

    def tap(it, put, depth=2):
        def record(b):
            seen.append(b.copy())
            return put(b)

        return prefetch(it, record, depth)

    monkeypatch.setattr(loop, "prefetch", tap)
    wd = str(tmp_path / "run")
    loop.run_teacher_training(cfg, wd, wav_dir, num_steps=2, device="cpu")
    seen.clear()
    res = loop.run_teacher_training(cfg, wd, wav_dir, num_steps=4,
                                    device="cpu")
    assert res.steps_run == 2
    train, _ = corpus_split(wav_dir)
    ds = WavCropDataset(None, cfg.dsp.sample_rate, files=train)
    seed, crop = cfg.train.seed, cfg.train.crop_samples
    want = {
        "auto": lambda: native_loader.NativeWavCropLoader(
            None, crop, 2, seed=seed, start_step=2, files=train),
        "python": lambda: make_train_iterator(ds, cfg, 2, seed=seed,
                                              start_step=2),
        "grain": lambda: make_grain_iterator(ds, cfg, 2, seed=seed,
                                             start_step=2),
    }[engine]()
    for got in seen[:2]:
        np.testing.assert_array_equal(got, next(want))


def test_auto_falls_back_where_the_loader_does_not_build(wav_dir, monkeypatch,
                                                         capsys):
    """Without a loader library "auto" trains on the Python iterator and
    says so; "native" raises the build's error."""
    def no_gxx():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native_loader, "load_native", no_gxx)
    res = _run_loop("teacher", _tiny(), wav_dir)
    assert res.steps_run == 1
    assert "[teacher] data engine: python" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="g.. not found"):
        _run_loop("teacher", _tiny(**{"train.data_engine": "native"}),
                  wav_dir)


def test_held_out_batch_matches_the_reference(wav_dir):
    """With a data dir the val batch comes from the held-out files, the
    reference's bit for bit, and the sample dumps' clip is held-out clip
    0."""
    from pwn_tpu.training.loop import make_val_batch as ref_val_batch

    cfg = _tiny()
    _, val = corpus_split(wav_dir)
    assert len(val) == 2
    np.testing.assert_array_equal(loop.make_val_batch(cfg, wav_dir, 2),
                                  ref_val_batch(jax_config(cfg), wav_dir, 2))
    held = loop.build_dataset(cfg, wav_dir, split="val")
    assert held.paths == val
    assert loop.build_dataset(cfg, wav_dir).paths == corpus_split(wav_dir)[0]


@pytest.mark.parametrize("name", ["teacher", "distill", "direct"])
@pytest.mark.parametrize("engine,error,match", [
    ("native", RuntimeError, "refusing to silently fall back"),
])
def test_data_engine_refusals(name, engine, error, match):
    """Fault F5: without a data_dir, "native" raises the reference's
    RuntimeError in every loop."""
    with pytest.raises(error, match=match):
        _run_loop(name, _tiny(**{"train.data_engine": engine}))


@pytest.mark.parametrize("name", ["teacher", "distill", "direct"])
def test_grain_engine_runs(name, capsys):
    """Without a data_dir "grain" trains on the synthetic corpus through
    grain, where grain is installed, in every loop."""
    pytest.importorskip("grain")
    res = _run_loop(name, _tiny(**{"train.data_engine": "grain"}))
    assert res.steps_run == 1
    assert all(np.isfinite(v) for v in res.final_metrics.values())
    assert "data engine: grain" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["auto", "python"])
def test_data_engines_that_run_the_iterator(engine):
    """"auto" and "python" train on the Python iterator."""
    res = _run_loop("teacher", _tiny(**{"train.data_engine": engine}))
    assert res.steps_run == 1 and np.isfinite(res.final_metrics["loss"])


# ------------------------------------------------------------- profiling


def test_step_profiler_and_debug_flags(tmp_path, monkeypatch):
    """PWN_TPU_PROFILE_DIR: a Chrome trace of steps 10..15, written when
    step 15 starts; unset, nothing.  PWN_TPU_DEBUG turns on autograd's
    anomaly detection."""
    from pwn_tpu_torch.utils import profiling

    monkeypatch.delenv(profiling.PROFILE_DIR_ENV, raising=False)
    idle = profiling.StepProfiler()
    for step in range(16):
        idle.step(step)
    idle.close()
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path))
    prof = profiling.StepProfiler()
    x = torch.ones(8)
    for step in range(16):
        prof.step(step)
        with profiling.trace_annotation(f"step_{step}"):
            x = x * 1.5
        assert not os.listdir(tmp_path) or step == 15
    prof.close()
    (trace,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / trace))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {f"step_{s}" for s in range(10, 15)} <= names
    assert "step_9" not in names and "step_15" not in names

    monkeypatch.setenv(profiling.DEBUG_ENV, "1")
    try:
        profiling.apply_debug_flags()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
