"""The benchmark's manifest and files: every workload resolves to its
configuration, traffic mix, limits and metric readers by name; names,
units and limits keep to the contract; the configuration files state what
the program runs; the generators are deterministic per seed; nothing on
the run path loads JAX or the JAX package, and the reference loads
nothing of the program.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
sys.path.insert(0, str(ROOT))

from perfbench import core, traffic_gen  # noqa: E402

MAN = core.manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    all_names = ([m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]],
                 WORKLOADS, names)
    for group in all_names:
        assert len(group) == len(set(group))
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_to_its_files(workload):
    files = core.cell_files(MAN, workload, ROOT)
    for kind in ("config", "traffic", "checks"):
        assert files[kind].is_file(), (workload, kind)
    traffic = core.load_json(files["traffic"])
    assert (PKG / "drivers" / f"{traffic['driver']}.py").is_file()
    checks = core.load_json(files["checks"])
    assert checks["limits"], workload
    e2e = core.metrics_for(MAN, workload, trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    per_layer = core.metrics_for(MAN, workload, trace=True)
    assert per_layer
    for m in per_layer:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {x["name"] for x in e2e}
        assert callable(core.metric_reader(m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_file_states_what_the_program_runs(config):
    entry = next(c for c in MAN["configs"] if c["name"] == config)
    data = core.load_json(ROOT / entry["file"])
    assert data["name"] == config and data["reduced"] == entry["reduced"]
    workload = next(w["name"] for w in MAN["workloads"]
                    if w["config"] == config)
    ctx = core.Context(workload, 1, 1.0, False, device="cpu")
    ctx.program_config()              # raises where a stated size differs


def test_lengths_are_one_multiset_in_a_seeded_order():
    spec = {"dist": "beta", "a": 2.4, "b": 1.55, "min_s": 1.11, "max_s": 10.1}
    a = traffic_gen.lengths_s(spec, 512, 2 ** 33 + 1)
    assert np.array_equal(a, traffic_gen.lengths_s(spec, 512, 2 ** 33 + 1))
    b = traffic_gen.lengths_s(spec, 512, 7)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert 6.4 < a.mean() < 6.8 and a.min() > 1.11 and a.max() < 10.1


def test_generators_are_deterministic_per_seed():
    f = [100, 37]
    for x, y in zip(traffic_gen.make_mels(f, 80, 5, "cpu"),
                    traffic_gen.make_mels(f, 80, 5, "cpu")):
        assert np.array_equal(x, y) and x.min() >= 0 and x.max() <= 1
    assert not np.array_equal(traffic_gen.make_mels(f, 80, 6, "cpu")[0],
                              traffic_gen.make_mels(f, 80, 5, "cpu")[0])
    a = traffic_gen.item_noise(3, 7, 1000, "cpu")
    assert np.array_equal(a.numpy(), traffic_gen.item_noise(3, 7, 1000, "cpu").numpy())
    assert not np.array_equal(a.numpy(), traffic_gen.item_noise(3, 8, 1000, "cpu").numpy())
    for x, y in zip(traffic_gen.tone_batches(11, 2, 3, 512, 22050),
                    traffic_gen.tone_batches(11, 2, 3, 512, 22050)):
        assert np.array_equal(x, y)


def test_tone_batches_equal_the_programs_stream():
    """The frozen copy rebuilds the batches the program's feed gives."""
    from pwn_tpu_torch.config import get_config, override
    from pwn_tpu_torch.training.loop import build_dataset, make_train_stream

    cfg = override(get_config("teacher_lj"), "train.seed", 123457)
    _, it = make_train_stream(cfg, None, build_dataset(cfg, None), 3, 0)
    ours = traffic_gen.tone_batches(123457, 3, 3, cfg.train.crop_samples,
                                    cfg.dsp.sample_rate)
    for k in range(3):
        assert np.array_equal(next(it), ours[k])


def test_item_noise_equals_the_programs_draw():
    """The frozen copy rebuilds the noise `vocode_many` draws for an item
    from its seed and index."""
    from pwn_tpu_torch.config import get_config
    from pwn_tpu_torch.generate import item_generator
    from pwn_tpu_torch.models.student import sample_base_noise

    cfg = get_config("student_iaf")
    for seed, i in ((2 ** 62 + 5, 0), (17, 311)):
        want = sample_base_noise(cfg, item_generator(seed, i, "cpu"), (4096,))
        assert np.array_equal(traffic_gen.item_noise(seed, i, 4096, "cpu")
                              .numpy(), want.numpy())


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "pwn_tpu"}
    for path in PKG.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & bad, (path, tops & bad)
        if "tests" not in path.relative_to(PKG).parts:
            text = path.read_text()
            assert "chip_smoke" not in text and "bench.py" not in text, path


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "pwn_tpu_torch" not in tops and "perfbench" not in tops, path


def test_run_path_loads_no_forbidden_module():
    """A process that imports everything a run imports, and runs a driver
    on the CPU at a tiny size, holds no forbidden top-level module."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import core, trace, work, calibrate\n"
        "from perfbench.drivers import vocode, train, ar, common\n"
        "import pwn_tpu_torch.generate, pwn_tpu_torch.training.loop\n"
        "ctx = core.Context('teacher_lj.ar', 5, 0.05, False, device='cpu',"
        " overrides={'batch': 1, 'frames': 1, 'inputs': 1, 'check_calls': 1})\n"
        "ar.run(ctx)\n"
        "print(core.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    assert core.forbidden_modules(["pwn_tpu_torch", "pwn_tpu_torch.ops",
                                   "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["pwn_tpu.models", "flax.core", "jax",
                                   "jaxlib.xla"]) == ["flax", "jax", "jaxlib",
                                                      "pwn_tpu"]


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    """Without a card run.py exits non-zero and prints no result; in a
    directory that holds only BENCHMARK.json and perfbench/ it does too."""
    import shutil

    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", WORKLOADS[0],
             "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, cwd=cwd, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
