"""The check that decides `correct`, driven here on the CPU at a size a
test run holds: each cell's run is made with the card's look skipped (the
program's CPU path is its plain versions), once sound, once with the
control (the reference in float8 in the program's place), and once for
each fault the cell can have, planted in its timed path: an answer
altered where it is produced, and for training a step that leaves the
state unchanged and a step over half of the batch.  The control and each
fault must come out not correct; the sound run must come out correct.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import core  # noqa: E402

SHORT = {"dist": "beta", "a": 2.4, "b": 1.55, "min_s": 1.11, "max_s": 1.3}
TINY = {
    "student_iaf.vocode": {"utterances": 3, "lengths": SHORT,
                           "batch_size": 2, "check_utterances": 2},
    "teacher_lj.train": {"batch": 2, "crop": 1024, "check_rows": 1,
                         "warm_steps": 0},
    "teacher_lj.ar": {"batch": 2, "frames": 1, "inputs": 2,
                      "check_calls": 1},
}
FAULTS = {"student_iaf.vocode": ["answer"], "teacher_lj.train": ["state", "half"],
          "teacher_lj.ar": ["answer"]}
CASES = ([(w, "program", None) for w in TINY]
         + [(w, "fp8", None) for w in TINY]
         + [(w, "program", f) for w in TINY for f in FAULTS[w]])


def _run(workload, candidate, fault, seed=2 ** 32 + 77):
    ctx = core.Context(workload, seed, 0.2, False, device="cpu",
                       overrides=TINY[workload], candidate=candidate,
                       fault=fault)
    out, _ = core.driver(ctx).run(ctx)
    return core.verdict(ctx, out)


@pytest.mark.parametrize("workload,candidate,fault", CASES,
                         ids=[f"{w}-{c}-{f}" for w, c, f in CASES])
def test_correct_tells_sound_runs_from_the_control_and_faults(
        workload, candidate, fault):
    ok, rows = _run(workload, candidate, fault)
    sound = candidate == "program" and fault is None
    assert ok == sound, rows
