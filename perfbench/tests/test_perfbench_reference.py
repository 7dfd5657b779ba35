"""The benchmark's plain reference against the program at tiny sizes on
the CPU, both in float32 (the program's CPU path is its plain versions):
the student's synthesis, the teacher's loss and gradients, one clipped
Adam step, the mel front end and the MoL draw.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import params  # noqa: E402
from perfbench.reference import wavenet as ref  # noqa: E402

INIT = {"bias_std": 0.1}
STUDENT = {"n_flows": 2, "layers_per_flow": 3, "residual_channels": 8,
           "gate_channels": 16, "skip_channels": 8, "n_mels": 80,
           "log_scale_clamp": 7.0, "upsample_strides": [16, 16],
           "upsample_kernel_mult": 2}
TEACHER = {"dilations": [1, 2, 4, 1, 2, 4], "residual_channels": 8,
           "gate_channels": 16, "skip_channels": 8, "n_mels": 80,
           "n_mixtures": 3, "log_scale_min": -9.0, "upsample_strides": [16, 16],
           "upsample_kernel_mult": 2}
DSP = {"sample_rate": 22050, "n_fft": 1024, "hop_length": 256,
       "win_length": 1024, "n_mels": 80, "fmin": 0.0, "fmax": None,
       "preemphasis": 0.97, "min_db": -100.0, "ref_db": 20.0}


def _student_cfg():
    from pwn_tpu_torch.config import get_config

    return get_config("student_iaf", **{
        "student.n_flows": 2, "student.layers_per_flow": 3,
        "student.residual_channels": 8, "student.gate_channels": 16,
        "student.skip_channels": 8, "student.compute_dtype": "float32"})


def _teacher_cfg():
    from pwn_tpu_torch.config import get_config

    return get_config("teacher_lj", **{
        "teacher.n_blocks": 2, "teacher.layers_per_block": 3,
        "teacher.residual_channels": 8, "teacher.gate_channels": 16,
        "teacher.skip_channels": 8, "teacher.n_mixtures": 3,
        "teacher.compute_dtype": "float32"})


def test_student_synthesis_matches_the_program():
    from pwn_tpu_torch.models.student import StudentIAF

    w = params.make_weights(params.student_spec(STUDENT), 3, "cpu", INIT)
    model = StudentIAF(_student_cfg(), device="cpu")
    model.load_state_dict(w, strict=True)
    gen = torch.Generator().manual_seed(1)
    mel = torch.rand((2, 6, 80), generator=gen)
    z = torch.randn((2, 6 * 256), generator=gen)
    with torch.no_grad():
        got = model.generate_from_z(z, mel)
        want = ref.student_wave(mel, z, w, STUDENT, "fp32")
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


def test_teacher_loss_and_gradients_match_the_program():
    from pwn_tpu_torch.models.teacher import TeacherWaveNet
    from pwn_tpu_torch.training.teacher import prepare_batch

    cfg = _teacher_cfg()
    w = params.make_weights(params.teacher_spec(TEACHER), 4, "cpu", INIT)
    model = TeacherWaveNet(cfg, stack_mode="train", device="cpu")
    model.load_state_dict(w, strict=True)
    raw = 0.5 * torch.sin(torch.linspace(0, 300, 2 * 2048)).view(2, 2048)
    x, mel = prepare_batch(raw, cfg)
    loss = model.loss(x, mel)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                allow_unused=True)
    want_loss, want = ref.teacher_loss_and_grads(raw, w, names, TEACHER, DSP,
                                                 "fp32", rows=1)
    assert abs(float(loss.detach()) - want_loss) < 1e-4 * abs(want_loss)
    for n, g in zip(names, grads):
        g = torch.zeros_like(want[n]) if g is None else g
        scale = float(want[n].abs().max()) + 1e-6
        assert float((g - want[n]).abs().max()) < 2e-3 * scale, n


def test_mel_front_end_matches_the_program():
    from pwn_tpu_torch.config import DSPConfig
    from pwn_tpu_torch.utils import dsp

    x = torch.rand((2, 4096)) * 2 - 1
    got = dsp.mel_spectrogram(x, DSPConfig())[:, : 4096 // 256]
    assert torch.allclose(got, ref.log_mel(x, DSP), atol=1e-5)
    assert np.allclose(ref.mel_filterbank(22050, 1024, 80, 0.0, 11025.0),
                       dsp.mel_filterbank(22050, 1024, 80, 0.0, 11025.0),
                       atol=1e-7)


def test_clipped_adam_matches_the_program():
    from pwn_tpu_torch.config import TrainConfig
    from pwn_tpu_torch.training.common import ClippedAdam

    cfg = TrainConfig(learning_rate=1e-3, grad_clip_norm=1.0)
    gen = torch.Generator().manual_seed(2)
    p0 = {"a": torch.randn(5, 3, generator=gen), "b": torch.randn(4, generator=gen)}
    ours = {k: v.clone() for k, v in p0.items()}
    theirs = [v.clone() for v in p0.values()]
    tx = ClippedAdam(cfg)
    st = tx.init(theirs)
    state: dict = {}
    train = {k: getattr(cfg, k) for k in ("learning_rate", "lr_decay_rate",
                                          "lr_decay_steps", "adam_b1",
                                          "adam_b2", "grad_clip_norm")}
    for _ in range(3):
        g = {k: torch.randn(v.shape, generator=gen) for k, v in p0.items()}
        ref.clipped_adam(ours, g, state, train)
        tx.update(theirs, list(g.values()), st)
    for a, b in zip(ours.values(), theirs):
        assert torch.allclose(a, b, atol=1e-7)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_mol_draw_matches_the_program(temperature):
    from pwn_tpu_torch.ops.mol import mol_sample_from_uniforms

    gen = torch.Generator().manual_seed(5)
    p = torch.randn((64, 30), generator=gen)
    u = 1e-5 + torch.rand((64, 11), generator=gen) * (1 - 2e-5)
    assert torch.allclose(ref.mol_draw(p, u, -9.0, temperature),
                          mol_sample_from_uniforms(p, u, -9.0, temperature),
                          atol=1e-6)


def test_teacher_forcing_matches_the_program():
    from pwn_tpu_torch.models.teacher import TeacherWaveNet

    cfg = _teacher_cfg()
    w = params.make_weights(params.teacher_spec(TEACHER), 6, "cpu", INIT)
    model = TeacherWaveNet(cfg, device="cpu")
    model.load_state_dict(w, strict=True)
    gen = torch.Generator().manual_seed(3)
    mel = torch.rand((2, 3, 80), generator=gen)
    wav = torch.rand((2, 768), generator=gen) * 2 - 1
    with torch.no_grad():
        got = model(wav, mel)
        cond = ref.match_length(ref.upsample(mel, w, "upsample.", [16, 16],
                                             "fp32"), 768)
        want = ref.teacher_params(wav, cond, w, TEACHER["dilations"], "fp32")
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


def test_fp8_operands_are_rounded():
    x = torch.tensor([0.1, 1.0 / 3, 500.0])
    y = ref.q(x, "fp8")
    assert y[2] == 448.0 and y[0] != x[0] and abs(float(y[1]) - 1 / 3) < 0.02
    assert ref.q(x, "fp32") is x
