"""The port's model axis (`pwn_tpu_torch/parallel/tp.py`), on the CPU with
Gloo: processes started as `torchrun` starts them
(`tests/torch_mesh_worker.py`), a free port and a timeout each.

- The sharding rules and `validate_tp`, as tests/test_tp.py holds the
  reference's.
- Under mesh 1 x 2 each rank holds half of every gate tensor's parameter,
  Adam moments and EMA.
- 1 x 2 ends bit-identical to 2 x 1 over the same world and batches, after
  3 teacher loop steps and after 2 distillation steps.
- A checkpoint written at 1 x 2 resumes at 2 x 1 and at 1 x 1, bit-
  identical to the uninterrupted run.
- Batch-sharded generation on 2 ranks (B = 4) and 4 ranks (B = 8) against
  the JAX package's unsharded `generate_from_z` on the same z (the
  tolerance of tests/test_tp.py), from a sharded state too, and its
  refusal.
- `dryrun_multichip(4)` on 4 processes; the averaging's backend choice.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pwn_tpu_torch import get_config, override
from pwn_tpu_torch.config import MeshConfig
from pwn_tpu_torch.parallel import mesh, tp
from pwn_tpu_torch.training import common
from pwn_tpu_torch.training.loop import run_teacher_training
from pwn_tpu_torch.utils.checkpoint import STATE_FILE, snapshot
from torch_parity import (SMALL_STUDENT, launch_workers, paired_students)

WORKER = str(Path(__file__).resolve().parent / "torch_mesh_worker.py")

# tests/test_torch_distributed.py's sizes (a 3-layer Gaussian-head teacher
# and SMALL_STUDENT, C=16, G=32, fp32; four 1,024-sample crops), with the
# EMA on so that it is sharded too
OVERRIDES = {
    **SMALL_STUDENT,
    "teacher.n_blocks": 1, "teacher.layers_per_block": 3,
    "teacher.residual_channels": 16, "teacher.gate_channels": 32,
    "teacher.skip_channels": 16, "teacher.output": "gaussian",
    "train.global_batch_size": 4, "train.crop_samples": 1024,
    "train.checkpoint_every": 2, "train.log_every": 1,
    "train.eval_sample_seconds": 0.02, "train.ema_decay": 0.9,
}
CFG = get_config("tiny_teacher")
for _k, _v in OVERRIDES.items():
    CFG = override(CFG, _k, _v)
SEED = 11   # the worker's generation seed
FRAMES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def students():
    """(JAX model, its params, the port's student with the same params)."""
    return paired_students(CFG)


def _setup(out: Path, port, B: int) -> np.ndarray:
    torch.save(port.state_dict(), out / "params.pt")
    mel = np.random.default_rng(B).uniform(
        0, 1, (B, FRAMES, CFG.dsp.n_mels)).astype(np.float32)
    np.save(out / "mel.npy", mel)
    return mel


@pytest.fixture(scope="module")
def two(tmp_path_factory, students):
    out = tmp_path_factory.mktemp("tp2")
    mel = _setup(out, students[2], 4)
    return out, mel, launch_workers(WORKER, 2, "tp", out, OVERRIDES,
                                    timeout=240)


@pytest.fixture(scope="module")
def four(tmp_path_factory, students):
    out = tmp_path_factory.mktemp("tp4")
    mel = _setup(out, students[2], 8)
    return out, mel, launch_workers(WORKER, 4, "tp4", out, OVERRIDES,
                                    timeout=240)


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------------- the rules


def test_param_spec_rules():
    assert tp.param_spec("stack.layer_3.w_dilated") == 2
    assert tp.param_spec("flow_0.layer_0.w_cond") == 1
    for leaf in ("b_dilated", "b_cond", "w_res", "w_skip"):
        assert tp.param_spec(f"stack.layer_0.{leaf}") == 0
    assert tp.param_spec("stack.head1.kernel") is None
    assert tp.param_spec("stack.layer_0.b_res") is None
    assert tp.param_spec("upsample.kernel_0") is None
    assert tp.param_spec("w_res") is None  # not under a layer


def test_validate_tp():
    tp.validate_tp(128, 2)
    tp.validate_tp(6, 1)
    with pytest.raises(ValueError, match="must divide over model axis 2"):
        tp.validate_tp(6, 2)


def test_process_grid_without_a_group(monkeypatch):
    """Rank = data_index * model + model_index, the model axis innermost;
    no subgroups without a process group; the refusals."""
    monkeypatch.setattr(mesh, "process_count", lambda: 4)
    monkeypatch.setattr(mesh, "process_index", lambda: 3)
    g = mesh.process_grid(MeshConfig(data=-1, model=2))
    assert (g.data, g.model, g.data_index, g.model_index) == (2, 2, 1, 1)
    assert g.model_group is None and g.data_group is None
    with pytest.raises(ValueError, match="not divisible by model=3"):
        mesh.process_grid(MeshConfig(data=-1, model=3))
    with pytest.raises(ValueError, match="does not cover 4 devices"):
        mesh.process_grid(MeshConfig(data=4, model=2))


def test_averaging_picks_the_op_by_the_groups_backend(monkeypatch, two):
    """NCCL averages natively; Gloo, for CPU and CUDA tensors alike, sums
    and divides: the choice follows the group's backend for the tensor's
    device, not the device.  On a real Gloo group of 2 the averaged
    tensors are the mean."""
    for config, want in (("cpu:gloo,cuda:nccl", (True, False)),
                         ("cpu:gloo,cuda:gloo", (False, False))):
        monkeypatch.setattr(common.dist, "get_backend_config",
                            lambda c=config: c)
        got = (common.averages_natively(torch.device("cuda", 0)),
               common.averages_natively("cpu"))
        assert got == want, config
    for r in two[2]:
        assert r["avg_native"] == (False, False)
        assert torch.equal(r["avg"][0], torch.full((3,), 1.5))
        assert float(r["avg"][1]) == 1.5


# -------------------------------------------------------- the model axis


def test_each_rank_holds_half_of_every_gate_tensor(two):
    """Under 1 x 2 each rank's parameter, mu, nu and EMA slice of a gate
    tensor is half of it on the split axis, in a storage of its own; its
    state bytes are below the unsharded run's by half the gate tensors."""
    _, _, ranks = two
    whole = ranks[0]["teacher_21"]
    for r in ranks:
        assert r["slices"], "no gate tensor was sharded"
        for k, (p, mu, nu, ema, *storage) in r["slices"].items():
            full = tuple(whole[f"params.{k}"].shape)
            axis = tp.param_spec(k)
            want = full[:axis] + (full[axis] // 2,) + full[axis + 1:]
            assert p == mu == nu == ema == want, k
            assert storage == [4 * int(np.prod(want))] * 3, k
        gate = sum(whole[f"params.{k}"].numel() * 4 for k in r["slices"])
        for part in ("params", "adam", "ema"):
            mult = 2 if part == "adam" else 1
            assert (r["bytes_21"][part] - r["bytes_12"][part]
                    == mult * gate // 2), part


def test_mesh_1x2_equals_2x1_bit_for_bit(two):
    """3 teacher loop steps and 2 distillation steps: the whole state
    (parameters, Adam's moments and count, EMA, step) on 1 x 2 equals 2 x 1
    bit for bit, on both ranks; the model's gate tensors equal the
    gathered parameters."""
    _, _, ranks = two
    for r in ranks:
        _same(r["teacher_12"], ranks[0]["teacher_21"])
        _same(r["distill_12"], ranks[0]["distill_21"])
        for k, p in r["model_12"].items():
            assert torch.equal(p, r["teacher_12"][f"params.{k}"]), k
    assert ranks[0]["teacher_12"]["step"] == 3
    assert ranks[0]["distill_12"]["step"] == 2


def test_a_1x2_checkpoint_resumes_at_2x1_and_1x1(two, tmp_path):
    """Stopped after its step-2 checkpoint at 1 x 2 and relaunched at 2 x 1
    to step 3: the step-3 checkpoint and the state equal the uninterrupted
    1 x 2 run's bit for bit.  One process (1 x 1) restores that checkpoint
    bit-identical to the sharded run's gathered state, and steps on."""
    out, _, ranks = two
    assert ranks[0]["resume_steps"] == (2, 1)
    want = torch.load(out / "a" / "ckpt_teacher" / "3" / STATE_FILE,
                      weights_only=True)
    got = torch.load(out / "c" / "ckpt_teacher" / "3" / STATE_FILE,
                     weights_only=True)
    _same(want, got)
    _same(want, ranks[0]["teacher_12"])
    for r in ranks:
        _same(r["resumed"], ranks[0]["teacher_12"])
    wd = tmp_path / "one"
    shutil.copytree(out / "c", wd)
    res = run_teacher_training(CFG, str(wd), num_steps=3, device="cpu")
    assert res.steps_run == 0
    _same(snapshot(res.state), ranks[0]["teacher_12"])
    res = run_teacher_training(CFG, str(wd), num_steps=4, device="cpu")
    assert res.steps_run == 1 and np.isfinite(res.final_metrics["loss"])


# ------------------------------------------------ batch-sharded generation


def _jax_generate(students, mel: np.ndarray) -> np.ndarray:
    model, params, _ = students
    T = mel.shape[1] * CFG.dsp.hop_length
    z = tp.global_noise(CFG, SEED, (mel.shape[0], T), "cpu").numpy()
    return np.asarray(model.apply({"params": params}, z, mel,
                                  method="generate_from_z"))


@pytest.mark.parametrize("world", [2, 4])
def test_batch_sharded_generate_matches_jax_unsharded(world, students, two,
                                                      four):
    """B = 2 * world rows over `world` ranks, each rank the same (B, T):
    within 1e-4 of JAX's unsharded generate_from_z on the same z and
    parameters (tests/test_tp.py's tolerance); on 2 ranks also from a
    state sharded over the model axis (bit-identical to the parameters'),
    and a batch of 3 refused."""
    _, mel, ranks = two if world == 2 else four
    ref = _jax_generate(students, mel)
    for r in ranks:
        assert torch.equal(r["bs"], ranks[0]["bs"])
        np.testing.assert_allclose(r["bs"].numpy(), ref, rtol=1e-4,
                                   atol=1e-4)
        if world == 2:
            assert torch.equal(r["bs_state"], r["bs"])
            assert "batch 3 not divisible by 2 devices" in r["bs_refusal"]


def test_batch_sharded_generate_on_one_rank_is_generate(students):
    """Without a process group: `generate_from_z` on the global noise, each
    row upsampled alone."""
    port = students[2]
    mel = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, FRAMES, CFG.dsp.n_mels)).astype(np.float32))
    got = tp.make_batch_sharded_generate(CFG)(port, SEED, mel)
    z = tp.global_noise(CFG, SEED, (2, FRAMES * CFG.dsp.hop_length), "cpu")
    with torch.no_grad():
        want = port.generate_from_z(z, mel)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_dryrun_multichip_on_4_processes(four):
    """`pwn_tpu_torch/dryrun.py::dryrun_multichip(4)` on 4 Gloo processes:
    a 2 x 2 mesh, every step finite, the generation shapes."""
    for r in four[2]:
        d = r["dryrun"]
        assert set(d) == {"teacher", "distill", "closed_form", "shapes",
                          "dp_teacher", "contrastive"}
        assert d["shapes"] == {"batch": (4, 1024), "sp": (1, 160 * 128)}
        assert d["closed_form"]["kl"] >= 0.0
