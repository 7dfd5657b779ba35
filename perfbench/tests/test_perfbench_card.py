"""Each cell once on the card, short, as the driver runs it: the result
line's keys, the device and `correct`.  Marked `gpu`; a fixture skips it
where there is no card.

    python -m pytest perfbench/tests -q -m gpu
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import core  # noqa: E402

WORKLOADS = [w["name"] for w in core.manifest(ROOT)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 12345), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
