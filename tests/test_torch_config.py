"""The port's own configuration (`pwn_tpu_torch/config.py`) against the JAX
package's: every preset field for field, `override` with its string
coercion, and the derived properties.  The two are separate classes, so
each package runs on its own config."""

import dataclasses

import pytest

import pwn_tpu.config as jc
from pwn_tpu_torch import config as pc
from pwn_tpu_torch import get_config, override


@pytest.mark.parametrize("name", jc.list_configs())
def test_every_preset_equals_the_reference(name):
    assert pc.list_configs() == jc.list_configs()
    cfg = get_config(name)
    assert type(cfg) is pc.Config and type(cfg) is not jc.Config
    assert pc.to_dict(cfg) == jc.to_dict(jc.get_config(name))


@pytest.mark.parametrize("key,value", [
    ("train.learning_rate", "3e-4"),
    ("teacher.n_blocks", "2"),
    ("teacher.upsample_strides", "(8,32)"),
    ("teacher.output", "gaussian"),
    ("train.tensorboard", "false"),
    ("dsp.fmax", 8000.0),
    ("distill.power_loss_resolutions", "((512,128,512),(2048,512,2048))"),
])
def test_override_matches_the_reference(key, value):
    got = override(get_config("teacher_lj"), key, value)
    want = jc.override(jc.get_config("teacher_lj"), key, value)
    assert pc.to_dict(got) == jc.to_dict(want)
    assert get_config("teacher_lj", **{key: value}) == got
    with pytest.raises(KeyError):
        override(got, key + "_x", value)


@pytest.mark.parametrize("name", ["tiny_teacher", "teacher_lj",
                                  "clarinet_gaussian",
                                  "large_student_sharded"])
def test_properties_match_the_reference(name):
    ours, ref = get_config(name), jc.get_config(name)
    for attr in ("dilations", "head_dim", "n_layers", "receptive_field"):
        assert getattr(ours.teacher, attr) == getattr(ref.teacher, attr)
    assert ours.student.flow_dilations == ref.student.flow_dilations
    assert ours.dsp.fmax_hz == ref.dsp.fmax_hz
    assert dataclasses.is_dataclass(ours) and hash(ours) == hash(
        get_config(name))


def test_unknown_preset_raises():
    with pytest.raises(KeyError, match="unknown config"):
        get_config("no_such_preset")
