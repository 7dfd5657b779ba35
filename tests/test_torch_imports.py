"""The port stands without JAX and without the JAX package, and its chip
smoke refuses to run without a card or without the repository.

The machine with the card has no JAX, and the port keeps its own copy of
everything it takes from `pwn_tpu` (the configuration included), so every
module of `pwn_tpu_torch` (and `chip_smoke.py`) must import with both `jax`
and `pwn_tpu` blocked.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["pwn_tpu"] = None  # and so does any import of the JAX package
import pwn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pwn_tpu_torch.__path__,
                                               "pwn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "pwn_tpu"))
print(" ".join(names))
print(len(names), loaded)
"""

# modules that must be among those walked: the entry points, the workdir's,
# the server's, the data engines, data parallelism, the model axis,
# sharded synthesis, the dry run and the benchmark suite, which the machine
# with the card runs without JAX
REQUIRED = ("pwn_tpu_torch.cli", "pwn_tpu_torch.utils.checkpoint",
            "pwn_tpu_torch.utils.metrics", "pwn_tpu_torch.utils.tensorboard",
            "pwn_tpu_torch.utils.profiling", "pwn_tpu_torch.ops.norm",
            "pwn_tpu_torch.training.loop",
            "pwn_tpu_torch.training.teacher_select", "pwn_tpu_torch.serve",
            "pwn_tpu_torch.evaluate", "pwn_tpu_torch.generate",
            "pwn_tpu_torch.utils.dsp", "pwn_tpu_torch.data.pipeline",
            "pwn_tpu_torch.data.native_loader",
            "pwn_tpu_torch.data.grain_pipeline",
            "pwn_tpu_torch.parallel.mesh", "pwn_tpu_torch.parallel.tp",
            "pwn_tpu_torch.parallel.sp", "pwn_tpu_torch.dryrun",
            "pwn_tpu_torch.benchmarks")


def _run(code_or_script, cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *code_or_script, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=240)


def test_every_port_module_imports_without_jax():
    proc = _run(["-c", _IMPORT_ALL], ROOT)
    assert proc.returncode == 0, proc.stderr
    walked, counts = proc.stdout.strip().splitlines()
    n, loaded = counts.split(" ", 1)
    assert int(n) >= 14  # the slice's modules, __init__s included
    assert set(REQUIRED) <= set(walked.split()), walked
    # only the blocking sentinels
    assert loaded == "['jax', 'pwn_tpu']", loaded
    # no module of the port, nor the smoke or the tools, names the JAX
    # package in an import, even one a test run would not reach
    sources = ["chip_smoke.py", *(
        str(p.relative_to(ROOT)) for p in [
            *ROOT.glob("pwn_tpu_torch/**/*.py"), *ROOT.glob("tools/torch_*.py")])]
    assert len(sources) >= 25
    for script in sorted(sources):
        text = (ROOT / script).read_text()
        assert not re.search(r"^\s*(from|import)\s+(pwn_tpu|jax)\b",
                             text, re.M), script


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "ModuleNotFoundError" in proc.stderr
