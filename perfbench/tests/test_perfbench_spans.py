"""The program's spans on the card, against the benchmark's traced window:
the recorder is on under the benchmark's CUDA-only profiler, the spans
share the device trace's clock (a `vocode.readback` span cannot end
before the device-to-host copy it waits on), and a traced run of each
host-bound cell prints the metrics read from the spans.  Marked `gpu`; a
fixture skips them where there is no card.

    python -m pytest perfbench/tests/test_perfbench_spans.py -q -m gpu
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

VOCODE = ("idle.vocode.cond", "idle.vocode.readback",
          "idle.vocode.deemphasis", "idle.vocode.rest")
TRAIN = ("idle.train.feed", "idle.train.forward", "idle.train.backward",
         "idle.train.optimizer", "idle.train.rest")
NEW = {"student_iaf.vocode": VOCODE + ("vocode.useful_rows",),
       "teacher_lj.train": TRAIN}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_recording_is_on_under_the_benchmarks_profiler(card):
    from perfbench.trace import Profiler
    from pwn_tpu_torch.utils.profiling import recording

    assert not recording()
    prof = Profiler()
    seen = []
    th = threading.Thread(target=lambda: seen.append(recording()))
    try:
        assert recording()
        th.start()
        th.join(timeout=30)
    finally:
        prof.stop()
    assert seen == [True]
    assert not recording()


@pytest.mark.gpu
def test_readback_spans_end_after_the_copies_they_wait_on(card):
    """Each `vocode.readback` span holds the start of a device-to-host copy
    and ends after the last such copy ends: the host returns from `.cpu()`
    only once the card has finished it."""
    import torch

    from perfbench.trace import Profiler
    from pwn_tpu_torch.config import get_config
    from pwn_tpu_torch.generate import vocode_many
    from pwn_tpu_torch.models.student import init_student
    from pwn_tpu_torch.utils import profiling

    cfg = get_config("student_iaf")
    model = init_student(cfg, torch.Generator().manual_seed(0),
                         device="cuda").eval()
    rng = np.random.default_rng(0)
    mels = [rng.uniform(0, 1, (f, cfg.dsp.n_mels)).astype(np.float32)
            for f in (120, 300, 310, 500, 64, 700, 90, 400, 250, 260)]
    kw = dict(seed=1, batch_size=4, bucket_frames=64)
    buckets = {}
    for m in mels:
        fb = -(-len(m) // 64)
        buckets[fb] = buckets.get(fb, 0) + 1
    groups = sum(-(-n // 4) for n in buckets.values())
    vocode_many(cfg, model, mels, **kw)          # warm every bucket
    profiling.clear()
    prof = Profiler()
    try:
        vocode_many(cfg, model, mels, **kw)
    finally:
        trace = prof.stop()
    copies = [(s, e) for n, s, e in trace.device if "DtoH" in n]
    spans = [s for s in profiling.recorded().spans
             if s.name == "vocode.readback"]
    assert len(spans) == groups == 7 and copies
    for sp in spans:
        mine = [(s, e) for s, e in copies if sp.start_ns <= s <= sp.end_ns]
        assert mine, sp
        assert sp.end_ns >= max(e for _, e in mine), (sp, mine)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(NEW))
def test_a_traced_run_prints_the_span_metrics(card, workload):
    """All of the cell's new metrics are printed; the vocode shares sum to
    at most the traced window's idle share."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 4242), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    got = line["metrics"]
    assert set(NEW[workload]) <= set(got), sorted(got)
    for name in NEW[workload]:
        assert got[name]["value"] >= 0, (name, got[name])
    if workload == "student_iaf.vocode":
        dev = line["device"]
        idle = 100.0 * (1 - dev["busy_s"] / dev["window_s"])
        assert sum(got[n]["value"] for n in VOCODE) <= idle + 1e-6
        assert 0 < got["vocode.useful_rows"]["value"] <= 100
