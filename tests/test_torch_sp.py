"""The port's sequence-parallel synthesis (`pwn_tpu_torch/parallel/sp.py`)
on the CPU with Gloo, processes started as `torchrun` starts them
(`tests/torch_mesh_worker.py`), against the JAX package's unsharded
`generate_from_z` on the same z: tests/test_sp.py's equivalence gates on
2 and 4 ranks.

- Overlap-recompute (`make_sp_generate_mega`): within 1e-4.
- Halo exchange (`make_sp_generate`): within rtol 1e-4 / atol 1e-5, with a
  4-way split whose shards (8 frames) are shorter than the upsampler's
  2H = 12-frame halo, so its frames come over two exchanges.
- The same programs served in one process (`sp_generate_in_process`,
  `local_window`) equal the group's output bit for bit.
- The reference's refusals ("max dilation", "overlap", "divisible"), and
  one rank degenerating to the plain `generate`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pwn_tpu_torch import get_config, override
from pwn_tpu_torch.parallel import sp, tp
from torch_parity import SMALL_STUDENT, launch_workers, paired_students

WORKER = str(Path(__file__).resolve().parent / "torch_mesh_worker.py")
CFG = get_config("tiny_teacher")
for _k, _v in SMALL_STUDENT.items():
    CFG = override(CFG, _k, _v)
SEED = 11   # the worker's generation seed
B, FRAMES = 2, 32   # R = 128 samples, H = 6 frames at hop 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX model, params, the port's student, mel, JAX's unsharded
    generate_from_z on the global noise, each world's rank results)."""
    model, params, port = paired_students(CFG)
    mel = np.random.default_rng(3).uniform(
        0, 1, (B, FRAMES, CFG.dsp.n_mels)).astype(np.float32)
    z = tp.global_noise(CFG, SEED, (B, FRAMES * CFG.dsp.hop_length), "cpu")
    ref = np.asarray(model.apply({"params": params}, z.numpy(), mel,
                                 method="generate_from_z"))
    runs = {}
    for world in (2, 4):
        out = tmp_path_factory.mktemp(f"sp{world}")
        torch.save(port.state_dict(), out / "params.pt")
        np.save(out / "mel_sp.npy", mel)
        runs[world] = launch_workers(WORKER, world, "sp", out, SMALL_STUDENT,
                                     timeout=180)
    return port, torch.from_numpy(mel), z, ref, runs


@pytest.mark.parametrize("world", [2, 4])
def test_sp_mega_matches_jax_unsharded(world, setup):
    _, _, _, ref, runs = setup
    for r in runs[world]:
        assert r["mega"].shape == ref.shape
        assert torch.equal(r["mega"], runs[world][0]["mega"])
        np.testing.assert_allclose(r["mega"].numpy(), ref, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_sp_matches_jax_unsharded(world, setup):
    _, _, _, ref, runs = setup
    for r in runs[world]:
        assert r["halo"].shape == ref.shape
        assert torch.equal(r["halo"], runs[world][0]["halo"])
        np.testing.assert_allclose(r["halo"].numpy(), ref, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_one_process_serves_the_same_programs(world, setup):
    """Every rank in turn in one process (the card's check): the halo path
    through `run_in_process`, the overlap path through `local_window`,
    bit-identical to the Gloo group's."""
    port, mel, z, _, runs = setup
    halo = sp.sp_generate_in_process(CFG, port, z, mel, world)
    assert torch.equal(halo, runs[world][0]["halo"])
    mega = torch.cat([sp.local_window(CFG, port, z, mel, r, world)
                      for r in range(world)], 1)
    assert torch.equal(mega, runs[world][0]["mega"])


@pytest.mark.parametrize("world", [2, 4])
def test_refusals(world, setup):
    """In the group: a shard shorter than the largest dilation, a shard
    shorter than the overlap and the upsampler's halo, frames that do not
    divide."""
    for r in setup[4][world]:
        msg = r["refusals"]
        assert "max dilation 512" in msg["max dilation"]
        assert "not divisible" in msg["halo divisible"]
        assert "overlap" in msg["overlap"]
        assert "not divisible" in msg["mega divisible"]


def test_validate_without_a_group():
    big = get_config("tiny_teacher")
    sp.validate_sp(big, 8, 32)  # 512-sample shards cover dilation 512
    with pytest.raises(ValueError, match="max dilation"):
        sp.validate_sp(big, 8, 16)
    with pytest.raises(ValueError, match="divisible"):
        sp.validate_sp(big, 8, 17)
    sp.validate_sp_mega(big, 1, 40)  # one rank: nothing to refuse
    with pytest.raises(ValueError, match="overlap"):
        sp.validate_sp_mega(big, 8, 64)
    with pytest.raises(ValueError, match="divisible"):
        sp.validate_sp_mega(big, 8, 321)
    with pytest.raises(ValueError, match="window exceeds the utterance"):
        sp.validate_sp_mega(CFG, 2, 14)


def test_one_rank_is_the_plain_generate(setup):
    """Without a process group both paths are the student's generate from
    the same generator, bit for bit."""
    port, mel, _, _, _ = setup
    with torch.no_grad():
        want = port.generate(torch.Generator().manual_seed(SEED), mel)
    assert torch.equal(sp.make_sp_generate_mega(CFG)(port, SEED, mel), want)
    assert torch.equal(sp.make_sp_generate(CFG)(port, SEED, mel), want)
