"""The port's data parallelism across processes, on the CPU with Gloo:
processes started by the test with a launcher's environment, as
`torchrun` sets it (`tests/torch_dp_worker.py`), each with a timeout and
a free port.

- Two ranks of half a batch average to JAX's single-device gradient on
  the whole batch (the spec of tests/test_distributed.py::
  test_dp_grads_match_single_device).
- Three loop steps of `run_teacher_training` on two processes over a wav
  dir (the native engine) equal one process stepping on the concatenated
  per-rank batches; each rank's batches are the reference loader's for
  its process_index; a run stopped after its step-2 checkpoint and
  relaunched ends bit-identical to the uninterrupted one; only rank 0
  writes under the workdir.
- A world of one is bit-identical to a run without a process group, for
  the teacher and for distillation.
- Distillation noise differs between ranks; a per-rank batch of 1 with
  the contrastive term, a batch that does not divide, and a mesh the
  processes cannot form are refused (the model axis: tests/test_torch_tp.py).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from pwn_tpu_torch import convert, get_config, override
from pwn_tpu_torch.config import MeshConfig
from pwn_tpu_torch.models.student import init_student
from pwn_tpu_torch.models.teacher import TeacherWaveNet, init_teacher
from pwn_tpu_torch.parallel import mesh
from pwn_tpu_torch.training.common import (create_train_state,
                                           step_generator)
from pwn_tpu_torch.training.distill import distillation_losses
from pwn_tpu_torch.training.teacher import make_teacher_train_step
from pwn_tpu_torch.utils.checkpoint import STATE_FILE
from torch_parity import jax_config, launch_workers

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(ROOT / "tests" / "torch_dp_worker.py")

# tiny_teacher's DSP (16 kHz, 40 mels, hop 128) with a 3-layer teacher
# (Gaussian head) and a 2 x 3-layer student at C=16, fp32, four 1,024-sample
# crops (two per rank), a checkpoint every 2 steps, a log every step,
# 4-frame dumps.  The Gaussian head, because the MoL likelihood's
# derivative cancels over bins 2/65535 wide: two reduction orders of the
# same gradient then differ by ~1e-4 of a tensor's norm
# (tests/test_torch_training.py::test_teacher_gradients_match_jax), and
# Adam turns that into 3e-5 to 3e-4 of a parameter's norm after 3 steps
# (2 ranks against the joined batch), against ~1e-7 with the Gaussian head.
OVERRIDES = {
    "student.n_flows": 2, "student.layers_per_flow": 3,
    "student.residual_channels": 16, "student.gate_channels": 32,
    "student.skip_channels": 16,
    "teacher.n_blocks": 1, "teacher.layers_per_block": 3,
    "teacher.residual_channels": 16, "teacher.gate_channels": 32,
    "teacher.skip_channels": 16, "teacher.output": "gaussian",
    "train.global_batch_size": 4, "train.crop_samples": 1024,
    "train.checkpoint_every": 2, "train.log_every": 1,
    "train.eval_sample_seconds": 0.02,
}


def _config(overrides):
    cfg = get_config("tiny_teacher")
    for k, v in overrides.items():
        cfg = override(cfg, k, v)
    return cfg


CFG = _config(OVERRIDES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(d: Path) -> str:
    """Six mono PCM16 clips at tiny_teacher's 16 kHz, 0.2-0.5 s."""
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        n = 3000 + 900 * i
        wavfile.write(str(d / f"clip_{i}.wav"), 16000,
                      (rng.uniform(-0.6, 0.6, n) * 32767).astype(np.int16))
    return str(d)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two-process runs over a wav dir, one after another (the suite's
    other workers share the host): 3 steps at once (workdir A), and 2
    steps then a relaunch to 3 (workdir B)."""
    root = tmp_path_factory.mktemp("dp")
    data = _corpus(root / "wavs")
    a, b = str(root / "a"), str(root / "b")
    whole = launch_workers(WORKER, 2, "loop", _mkdir(root / "out_a"), OVERRIDES, a, data, 3)
    first = launch_workers(WORKER, 2, "loop", _mkdir(root / "out_b1"), OVERRIDES, b, data, 2)
    resumed = launch_workers(WORKER, 2, "loop", _mkdir(root / "out_b2"), OVERRIDES, b, data,
                      3)
    return data, a, b, whole, first, resumed


@pytest.fixture(scope="module")
def grad_run(tmp_path_factory):
    """JAX's teacher (seed 0) and a batch of 4, and two ranks' averaged
    gradient of it, each rank taking half: (jax model, variables, batch,
    rank results)."""
    import jax

    from pwn_tpu.models.teacher import init_teacher as jax_init_teacher

    out = tmp_path_factory.mktemp("grads")
    model, variables = jax_init_teacher(jax_config(CFG),
                                        jax.random.PRNGKey(0), use_scan=False)
    torch.save(convert.params_from_flax(jax.tree.map(np.asarray, variables)),
               out / "params.pt")
    wav = np.random.default_rng(1).uniform(-0.6, 0.6, (4, 1024)).astype(
        np.float32)
    np.save(out / "batch.npy", wav)
    return model, variables, wav, launch_workers(WORKER, 2, "grads", out, OVERRIDES)


def _mkdir(p: Path) -> Path:
    p.mkdir()
    return p


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ----------------------------------------------------------- (a) gradients


def test_averaged_gradient_equals_jax_on_the_whole_batch(grad_run):
    """Two ranks, each the gradient of its half of a batch of 4, averaged
    by `average_across_processes`: every parameter's gradient within 1e-5
    (relative L2) of JAX's single-device gradient on the whole batch, and
    of the port's own; the averaged loss within 1e-5 of JAX's."""
    import jax
    import jax.numpy as jnp

    from pwn_tpu.training.teacher import prepare_batch as jax_prepare

    from pwn_tpu_torch.training.teacher import prepare_batch

    model, variables, wav, (r0, r1) = grad_run
    x, mel = jax_prepare(jnp.asarray(wav), jax_config(CFG))
    loss, grads = jax.value_and_grad(lambda p: model.apply(
        {"params": p}, x, mel, method="loss"))(variables["params"])
    want = convert.params_from_flax(jax.tree.map(np.asarray, grads))
    port = TeacherWaveNet(CFG, stack_mode="train")
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    names, ps = zip(*port.named_parameters())
    own = dict(zip(names, torch.autograd.grad(
        port.loss(*prepare_batch(torch.from_numpy(wav), CFG)), ps)))
    assert set(r0["grads"]) == set(want) == set(own)
    for k, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][k]), k  # the same on both ranks
        if want[k].any():
            assert _rel(g, want[k]) <= 1e-5, (k, _rel(g, want[k]))
            assert _rel(g, own[k]) <= 1e-5, (k, _rel(g, own[k]))
        else:
            assert not g.any(), k
    np.testing.assert_allclose(float(r0["loss"]), float(loss), rtol=1e-5)


def test_distillation_noise_differs_between_ranks(grad_run):
    """The step generator of (seed, step) draws differently on each rank,
    and rank 0 draws what a run without a process group draws."""
    r0, r1 = grad_run[-1]
    alone = torch.rand(8, generator=step_generator(5, 3, "cpu"))
    assert torch.equal(r0["noise"], alone)
    assert not torch.equal(r0["noise"], r1["noise"])
    assert torch.equal(torch.rand(8, generator=step_generator(5, 3, "cpu",
                                                               rank=1)),
                       r1["noise"])


# ------------------------------------------------------ (b)-(d) the loop


def test_two_process_loop_equals_one_process_on_the_joined_batches(runs):
    """3 steps on 2 processes (native engine, 2 crops each): each rank's
    batches bit-identical to the reference's C++ loader for its
    process_index; the losses and final parameters within 1e-5 (relative)
    of one process stepping on both ranks' batches joined."""
    from pwn_tpu.data.native_loader import NativeWavCropLoader
    from pwn_tpu.data.pipeline import corpus_split

    data, a, _, whole, _, _ = runs
    for rank, r in enumerate(whole):
        assert r["steps_run"] == 3
        ref = NativeWavCropLoader(None, CFG.train.crop_samples, 2,
                                  seed=CFG.train.seed, process_index=rank,
                                  process_count=2,
                                  files=corpus_split(data)[0])
        for step in range(3):
            np.testing.assert_array_equal(r["batches"][step], next(ref))
        ref.close()
    assert not np.array_equal(whole[0]["batches"], whole[1]["batches"])
    for k, p in whole[0]["params"].items():
        assert torch.equal(p, whole[1]["params"][k]), k

    model = init_teacher(CFG, torch.Generator().manual_seed(CFG.train.seed),
                         stack_mode="train", device="cpu")
    state = create_train_state(dict(model.named_parameters()), CFG.train)
    step_fn = make_teacher_train_step(model, CFG)
    losses = []
    for step in range(3):
        joined = np.concatenate([whole[0]["batches"][step],
                                 whole[1]["batches"][step]])
        state, m = step_fn(state, torch.from_numpy(joined))
        losses.append(float(m["loss"]))
    logged = [json.loads(line) for line in
              open(os.path.join(a, "metrics_teacher.jsonl"))]
    np.testing.assert_allclose([r["loss"] for r in logged if "loss" in r],
                               losses, rtol=1e-5)
    for k, p in state.params.items():
        assert _rel(whole[0]["params"][k], p.detach()) <= 1e-5, k


def test_two_process_resume_is_bit_identical(runs):
    """Stopped after its step-2 checkpoint and relaunched to step 3, the
    run's step-3 checkpoint and final parameters equal the uninterrupted
    run's bit for bit; the relaunch resumed both ranks at step 2."""
    _, a, b, whole, first, resumed = runs
    assert [r["steps_run"] for r in first + resumed] == [2, 2, 1, 1]
    want = torch.load(os.path.join(a, "ckpt_teacher", "3", STATE_FILE),
                      weights_only=True)
    got = torch.load(os.path.join(b, "ckpt_teacher", "3", STATE_FILE),
                     weights_only=True)
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert torch.equal(want[k], got[k]), k
        else:
            assert want[k] == got[k], k
    for rank in (0, 1):
        np.testing.assert_array_equal(resumed[rank]["batches"][0],
                                      whole[rank]["batches"][2])
        for k, p in whole[rank]["params"].items():
            assert torch.equal(p, resumed[rank]["params"][k]), k


def test_only_rank_0_writes(runs):
    """Rank 1 creates, renames and removes nothing under the workdir in any
    launch; rank 0 writes the checkpoints, the metrics, TensorBoard and
    the sample dumps, each once."""
    _, a, _, whole, first, resumed = runs
    for r in (whole[1], first[1], resumed[1]):
        assert r["writes"] == []
    written = {os.path.relpath(p, a).split(os.sep)[0]
               for _, p in whole[0]["writes"]}
    assert {"ckpt_teacher", "metrics_teacher.jsonl", "tb_teacher",
            "samples"} <= written
    assert sorted(os.listdir(a)) == ["ckpt_teacher", "metrics_teacher.jsonl",
                                     "samples", "tb_teacher"]
    assert len(os.listdir(os.path.join(a, "tb_teacher"))) == 1
    steps = [json.loads(line)["step"] for line in
             open(os.path.join(a, "metrics_teacher.jsonl"))]
    assert steps == [0, 1, 2, 2, 3]  # loss at 0, 1, 2; val_loss at 2, 3
    assert sorted(os.listdir(os.path.join(a, "samples"))) == [
        "step_00000002.wav", "step_00000003.wav"]


# ----------------------------------------------------------- world of one


def test_a_world_of_one_is_bit_identical(tmp_path):
    """One process with a launcher's environment (a one-rank Gloo group):
    the teacher and distillation loops (the contrastive term on, 2 steps,
    a wav dir) end bit-identical to the same runs without a group."""
    data = _corpus(tmp_path / "wavs")
    cfg = {**OVERRIDES, "distill.contrastive_weight": 0.3,
           "train.global_batch_size": 2}
    (r,) = launch_workers(WORKER, 1, "world1", tmp_path, cfg, data)
    for alone, group in zip(r["alone"][:2], r["group"][:2]):
        assert alone.keys() == group.keys()
        for k in alone:
            assert torch.equal(alone[k], group[k]), k
    assert r["alone"][2:] == r["group"][2:]


# --------------------------------------------------------------- refusals


def test_contrastive_refuses_a_per_rank_batch_of_1():
    """With the contrastive term on, a batch of one row (the roll is the
    identity there) raises; two rows run."""
    cfg = override(CFG, "distill.contrastive_weight", 0.3)
    student = init_student(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    teacher = init_teacher(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    hop, m = cfg.dsp.hop_length, cfg.dsp.n_mels
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="batch of at least 2 per process"):
        distillation_losses(student, teacher, torch.zeros(1, 8 * hop),
                            torch.zeros(1, 8, m), cfg, generator=gen)
    loss, _ = distillation_losses(student, teacher, torch.zeros(2, 8 * hop),
                                  torch.zeros(2, 8, m), cfg, generator=gen)
    assert torch.isfinite(loss)


def test_local_batch_and_mesh_refusals(monkeypatch):
    """The global batch divided by the world size, or the reference's
    ValueError; a mesh whose data x model is not the world size raises
    ValueError, and `mesh.model` > 1 is accepted where it is; without a
    group the process is a world of one."""
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.local_batch_size(8) == 8
    mesh.mesh_shape(MeshConfig(data=-1, model=1))
    mesh.mesh_shape(MeshConfig(data=1, model=1))
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    assert mesh.local_batch_size(8) == 4
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        mesh.local_batch_size(3)
    with pytest.raises(ValueError, match="does not cover 2 devices"):
        mesh.mesh_shape(MeshConfig(data=4, model=1))
    mesh.mesh_shape(MeshConfig(data=2, model=1))
    mesh.mesh_shape(MeshConfig(data=-1, model=2))
    mesh.mesh_shape(MeshConfig(data=1, model=2))
    with pytest.raises(ValueError, match="does not cover 2 devices"):
        mesh.mesh_shape(MeshConfig(data=2, model=2))
    with pytest.raises(ValueError, match="not divisible by model=4"):
        mesh.mesh_shape(MeshConfig(data=-1, model=4))


def test_ensure_distributed_without_a_launcher(monkeypatch):
    """No `WORLD_SIZE` in the environment: no group is made."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh.ensure_distributed(torch.device("cpu"))
    assert not dist.is_initialized()
