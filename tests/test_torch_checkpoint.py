"""The port's checkpoint format (`utils/checkpoint.py`) on the CPU at tiny
sizes: a full TrainState round trip, the retained ladder, commits that
count and leftovers that do not, a failed write raised at `wait`, strict
restore, and the model's cached stack weights after a restore.
"""

import os

import numpy as np
import pytest
import torch

from pwn_tpu_torch import get_config, override
from pwn_tpu_torch.models.teacher import init_teacher
from pwn_tpu_torch.training.common import create_train_state
from pwn_tpu_torch.training.teacher import make_teacher_train_step
from pwn_tpu_torch.utils.checkpoint import (STATE_FILE, CheckpointManager,
                                            state_tensors)

TINY = get_config("tiny_teacher")
for _k, _v in {"teacher.n_blocks": 1, "teacher.layers_per_block": 3,
               "teacher.residual_channels": 16, "teacher.gate_channels": 32,
               "teacher.skip_channels": 16, "teacher.n_mixtures": 4,
               "train.ema_decay": 0.9}.items():
    TINY = override(TINY, _k, _v)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it, so these tests run
    torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trained(seed: int, steps: int = 2, cfg=TINY):
    """A tiny teacher ("train" stacks) and its TrainState after `steps`
    optimizer steps on a numpy-seeded batch: Adam's moments, its count and
    the EMA all moved off their initial values."""
    model = init_teacher(cfg, torch.Generator().manual_seed(seed),
                         stack_mode="train", device="cpu")
    state = create_train_state(dict(model.named_parameters()), cfg.train,
                               seed=seed + 5)
    wav = torch.from_numpy(np.random.default_rng(seed).uniform(
        -0.5, 0.5, (2, 1024)).astype(np.float32))
    step = make_teacher_train_step(model, cfg)
    for _ in range(steps):
        state, _ = step(state, wav)
    return model, state


def _equal_states(a, b):
    assert (a.step, a.seed, a.opt_state.count) == (
        b.step, b.seed, b.opt_state.count)
    ta, tb = state_tensors(a), state_tensors(b)
    assert list(ta) == list(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_round_trip_of_a_full_state_is_bit_exact(tmp_path):
    """params, mu, nu, count, step, seed and the EMA come back bit for bit
    into another model's tensors, in place; the file is a flat dict of
    tensors and ints that loads with weights_only."""
    _, state = _trained(0)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(state.step, state)
    ckpt.wait()
    flat = torch.load(tmp_path / "ckpt" / "2" / STATE_FILE, weights_only=True)
    assert flat["step"] == 2 and flat["opt.count"] == 2 and flat["seed"] == 5
    assert any(k.startswith("ema.") for k in flat)
    assert all(isinstance(v, (int, torch.Tensor)) for v in flat.values())

    _, other = _trained(1, steps=0)
    live = state_tensors(other)
    ptrs = {k: t.data_ptr() for k, t in live.items()}
    restored, step = ckpt.restore(other)
    assert step == 2 and restored is other
    _equal_states(restored, state)
    assert {k: t.data_ptr() for k, t in state_tensors(restored).items()} == ptrs
    ckpt.close()


def test_save_snapshots_at_once(tmp_path):
    """The state changes in place right after `save` returns (the next
    train step): the checkpoint holds the values at the save."""
    _, state = _trained(0, steps=1)
    want = {k: t.clone() for k, t in state_tensors(state).items()}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state)
    with torch.no_grad():
        for t in state_tensors(state).values():
            t.add_(1.0)
    ckpt.wait()
    flat = torch.load(tmp_path / "1" / STATE_FILE, weights_only=True)
    for k, t in want.items():
        assert torch.equal(flat[k], t), k


def test_the_ladder_keeps_the_last_max_to_keep(tmp_path):
    """keep_checkpoints=3: saves at 2, 4, 6 retain [2, 4, 6]; one more at 8
    prunes 2."""
    _, state = _trained(0, steps=0)
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=3)
    assert ckpt.latest_step() is None and ckpt.all_steps() == []
    for s in (2, 4, 6):
        ckpt.save(s, state)
    ckpt.wait()
    assert ckpt.all_steps() == [2, 4, 6] and ckpt.latest_step() == 6
    ckpt.save(8, state)
    ckpt.close()
    assert ckpt.all_steps() == [4, 6, 8]
    assert sorted(os.listdir(tmp_path)) == ["4", "6", "8"]


def test_leftovers_of_an_interrupted_save_are_not_steps(tmp_path):
    """A temporary directory left by a crash mid-save, or a step directory
    without its file, does not count: the previous step stays the
    latest."""
    _, state = _trained(0, steps=0)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(2, state)
    ckpt.wait()
    tmp = tmp_path / ".tmp-4-0123abcd"
    tmp.mkdir()
    (tmp / STATE_FILE).write_bytes(b"partial")
    (tmp_path / "6").mkdir()
    assert ckpt.all_steps() == [2] and ckpt.latest_step() == 2
    again = CheckpointManager(str(tmp_path))
    assert again.latest_step() == 2
    _, template = _trained(1, steps=0)
    assert again.restore(template)[1] == 2


def test_a_failed_write_raises_at_wait(tmp_path):
    """The directory is gone and a file stands at its path: the write on
    the background thread fails, and `wait` raises it; nothing counts as a
    step."""
    _, state = _trained(0, steps=0)
    d = tmp_path / "ckpt"
    ckpt = CheckpointManager(str(d))
    os.rmdir(d)
    d.write_text("not a directory")
    ckpt.save(2, state)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ckpt.wait()
    ckpt.wait()  # raised once
    assert ckpt.all_steps() == []


def test_restore_is_strict(tmp_path):
    """No checkpoint: FileNotFoundError.  A template without the EMA the
    checkpoint holds, or of other widths: ValueError, nothing copied."""
    _, state = _trained(0, steps=0)
    ckpt = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    ckpt.save(3, state)
    ckpt.wait()
    _, no_ema = _trained(1, steps=0, cfg=override(TINY, "train.ema_decay", 0.0))
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore(no_ema)
    _, wide = _trained(1, steps=0,
                       cfg=override(TINY, "teacher.residual_channels", 24))
    before = {k: t.clone() for k, t in state_tensors(wide).items()}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(wide)
    assert all(torch.equal(before[k], t)
               for k, t in state_tensors(wide).items())


def test_cached_stack_weights_follow_a_restore(tmp_path):
    """The stack's weight layout, built and cached under no_grad, is
    rebuilt from the restored parameters: restore copies in place, which
    bumps each tensor's version."""
    model_a, state_a = _trained(0)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(2, state_a)
    ckpt.wait()
    model_b, state_b = _trained(1, steps=0)
    with torch.no_grad():
        old = model_b.stack.stacked()
    ckpt.restore(state_b)
    with torch.no_grad():
        cached = model_b.stack.stacked()
        model_b.stack._cache.clear()
        fresh = model_b.stack.stacked()
        want = model_a.stack.stacked()
    assert not torch.equal(old[0], cached[0])
    for c, f, w in zip(cached, fresh, want):
        assert torch.equal(c, f) and torch.equal(c, w)
