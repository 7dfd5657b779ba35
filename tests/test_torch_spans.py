"""The program's spans and counters (`pwn_tpu_torch/utils/profiling.py`)
and the benchmark's join of them with the device trace
(`perfbench/spans.py`), on the CPU.

Spans record only while a `torch.profiler` session runs; they nest by
thread, share the profiler's clock, and sit where `vocode_many`, the train
steps and the prefetch thread do their host work.  The join puts each
idle gap of a trace down to the innermost span of the issuing thread.
"""

import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pwn_tpu_torch import get_config, override
from pwn_tpu_torch.data.pipeline import prefetch
from pwn_tpu_torch.generate import vocode_many
from pwn_tpu_torch.models.modules import resolve_stack_mode
from pwn_tpu_torch.models.student import init_student
from pwn_tpu_torch.models.teacher import init_teacher
from pwn_tpu_torch.training import loop
from pwn_tpu_torch.training.common import create_train_state
from pwn_tpu_torch.training.distill import make_distill_train_step
from pwn_tpu_torch.training.student_direct import \
    make_student_direct_train_step
from pwn_tpu_torch.training.teacher import make_teacher_train_step
from pwn_tpu_torch.utils import profiling
from pwn_tpu_torch.utils.profiling import Span
from torch_parity import SMALL_STUDENT

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import core  # noqa: E402
from perfbench import spans as join  # noqa: E402
from perfbench.trace import Trace  # noqa: E402


def _tiny(**overrides):
    """tiny_teacher's DSP (40 mels, hop 128), a 3-layer teacher and a
    2 x 3-layer student at C=16, fp32, two 1,024-sample crops."""
    cfg = get_config("tiny_teacher")
    for k, v in {
        **SMALL_STUDENT, "teacher.n_blocks": 1, "teacher.layers_per_block": 3,
        "teacher.residual_channels": 16, "teacher.gate_channels": 32,
        "teacher.skip_channels": 16, "teacher.n_mixtures": 4,
        "train.global_batch_size": 2, "train.crop_samples": 1024,
        **overrides,
    }.items():
        cfg = override(cfg, k, v)
    return cfg


@pytest.fixture(autouse=True)
def _fresh():
    """Each test starts and ends with an empty store and one torch thread
    (several pytest workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(n)


def _cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _names(rec, thread=None):
    return [s.name for s in rec.spans
            if thread is None or s.thread == thread]


def _inside(rec, outer):
    """Names of the spans of `outer`'s thread that lie within it, in the
    order they were entered: nesting is by time, as the join reads it."""
    return [s.name for s in rec.spans if s is not outer
            and s.thread == outer.thread
            and outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns]


# ---------------------------------------------------------------- recorder


def test_nothing_is_recorded_without_a_profiler():
    assert not profiling.recording()
    assert profiling.span("a") is profiling.span("b")   # the shared no-op
    with profiling.span("a"):
        with profiling.span("b"):
            profiling.count("c", 3)
    rec = profiling.recorded()
    assert rec.spans == [] and rec.counts == {} and rec.dropped == 0


def test_spans_nest_by_thread_with_their_parents():
    """Under a CPU profiler: each span lies within the span that enclosed
    it on the same thread, a second thread's spans are its own, counters
    add up, and the store is read without being cleared."""
    def worker():
        with profiling.span("w.outer"):
            with profiling.span("w.inner"):
                profiling.count("n", 2)

    with _cpu_profiler():
        assert profiling.recording()
        with profiling.span("outer"):
            with profiling.span("inner.a"):
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
            with profiling.span("inner.b"):
                with profiling.span("leaf"):
                    profiling.count("n")
    assert not th.is_alive()
    rec = profiling.recorded()
    assert profiling.recorded() == rec
    main = threading.get_native_id()
    assert _names(rec, main) == ["outer", "inner.a", "inner.b", "leaf"]
    by = {s.name: s for s in rec.spans}
    assert _inside(rec, by["outer"]) == ["inner.a", "inner.b", "leaf"]
    assert _inside(rec, by["inner.a"]) == []
    assert _inside(rec, by["inner.b"]) == ["leaf"]
    assert _inside(rec, by["w.outer"]) == ["w.inner"]
    assert by["w.outer"].thread == by["w.inner"].thread != main
    assert by["inner.a"].start_ns <= by["w.outer"].start_ns
    assert by["w.outer"].end_ns <= by["inner.a"].end_ns
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns
    assert rec.counts == {"n": 3} and rec.dropped == 0
    profiling.clear()
    assert profiling.recorded().spans == []


def test_the_bound_drops_new_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with _cpu_profiler():
        with profiling.span("kept"):
            for k in range(4):
                with profiling.span(f"child{k}"):
                    pass
    got = profiling.recorded()
    assert [s.name for s in got.spans] == ["kept", "child0", "child1"]
    assert got.dropped == 2
    assert all(s.end_ns is not None for s in got.spans)


def test_a_span_contains_its_ops_kineto_interval():
    """The shared clock: the profiler's own interval of a CPU op issued
    inside a span lies within the span, and the span's `record_function`
    shows in the profiler's events under its name."""
    x = torch.randn(256, 256)
    with _cpu_profiler() as prof:
        for _ in range(3):
            with profiling.span("clock"):
                x = torch.tanh(x @ x)
    spans = [s for s in profiling.recorded().spans if s.name == "clock"]
    events = prof.profiler.kineto_results.events()
    mms = sorted((e.start_ns(), e.end_ns()) for e in events
                 if e.name() == "aten::mm")
    assert len(spans) == len(mms) == 3
    for s, (a, b) in zip(spans, mms):
        assert s.start_ns <= a <= b <= s.end_ns, (s, a, b)
    assert sum(e.name() == "clock" for e in events) == 3


# ----------------------------------------------------- spans in the program


def test_vocode_many_records_each_group_and_counts_its_samples():
    """A ragged job over three buckets at batch 2: `vocode.cond`,
    `vocode.readback` and `vocode.deemphasis` once a group, in the
    pipeline's order (group n+1's conditioning before group n's readback
    and deemphasis), and the counters equal to the bucket arithmetic:
    every group counted, all but the last read back overlapped."""
    cfg = _tiny()
    model = init_student(cfg, torch.Generator().manual_seed(0),
                         device="cpu").eval()
    hop, bucket, batch = cfg.dsp.hop_length, 16, 2
    frames = [8, 21, 37, 20, 9, 30]
    rng = np.random.default_rng(3)
    mels = [rng.uniform(0, 1, (f, cfg.dsp.n_mels)).astype(np.float32)
            for f in frames]
    with _cpu_profiler():
        outs = vocode_many(cfg, model, mels, seed=4, batch_size=batch,
                           bucket_frames=bucket)
    assert [len(o) for o in outs] == [f * hop for f in frames]
    rec = profiling.recorded()
    sizes = {}
    for f in frames:
        fb = -(-f // bucket) * bucket
        sizes[fb] = sizes.get(fb, 0) + 1
    groups = sum(-(-n // batch) for n in sizes.values())
    assert groups == 4
    assert rec.counts == {
        "vocode.samples_computed":
            sum(-(-n // batch) * batch * fb * hop for fb, n in sizes.items()),
        "vocode.samples_useful": sum(frames) * hop,
        "vocode.groups": 4, "vocode.groups_overlapped": 3}
    assert _names(rec) == (
        ["vocode.cond"]
        + ["vocode.cond", "vocode.readback", "vocode.deemphasis"]
        * (groups - 1)
        + ["vocode.readback", "vocode.deemphasis"])
    for a, b in zip(rec.spans, rec.spans[1:]):
        assert a.end_ns <= b.start_ns


@pytest.mark.parametrize("frames,batch,share", [
    ([20], 2, 0.0), ([20, 21, 22], 2, 50.0), ([20, 21, 22, 23, 24], 1, 80.0)])
def test_overlapped_groups_reads_the_pipelines_counters(frames, batch, share):
    """`vocode.overlapped_groups` is the share of a call's groups read back
    after the next group was enqueued: all but the last; nothing where the
    program counted no group."""
    cfg = _tiny()
    model = init_student(cfg, torch.Generator().manual_seed(0),
                         device="cpu").eval()
    mels = [np.full((f, cfg.dsp.n_mels), 0.5, np.float32) for f in frames]
    read = core.metric_reader("vocode.overlapped_groups")
    assert read(None) is None
    with _cpu_profiler():
        vocode_many(cfg, model, mels, batch_size=batch, bucket_frames=32)
    assert read(None) == share


def _teacher_step(cfg):
    model = init_teacher(cfg, torch.Generator().manual_seed(0),
                         stack_mode=resolve_stack_mode(
                             cfg.teacher.fused_layers, "train"),
                         device="cpu")
    state = create_train_state(dict(model.named_parameters()), cfg.train)
    return state, make_teacher_train_step(model, cfg)


def _distill_step(cfg):
    teacher = init_teacher(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    teacher = loop.frozen_teacher(cfg, teacher.state_dict(), "cpu")
    student, state = loop._student(cfg, torch.device("cpu"))
    return state, make_distill_train_step(student, teacher, cfg)


def _direct_step(cfg):
    student, state = loop._student(cfg, torch.device("cpu"))
    return state, make_student_direct_train_step(student, cfg)


STEP = ["train.prepare", "train.forward", "train.backward", "train.reduce",
        "train.norm", "train.update"]


@pytest.mark.parametrize("path,ema", [("teacher", 0.0), ("teacher", 0.5),
                                      ("distill", 0.5), ("direct", 0.0)])
def test_train_steps_record_their_children(path, ema):
    """Each train step is one `train.step` over its children in order;
    `train.ema` only where `ema_decay` > 0 (teacher_lj runs with 0)."""
    cfg = _tiny(**{"train.ema_decay": ema})
    make = {"teacher": _teacher_step, "distill": _distill_step,
            "direct": _direct_step}[path]
    state, step = make(cfg)
    wav = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (2, 1024)).astype(np.float32))
    state, metrics = step(state, wav)                   # not recorded
    assert profiling.recorded().spans == []
    with _cpu_profiler():
        for _ in range(2):
            state, metrics = step(state, wav)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    rec = profiling.recorded()
    steps = [s for s in rec.spans if s.name == "train.step"]
    assert len(steps) == 2
    want = STEP + (["train.ema"] if ema > 0 else [])
    assert _names(rec) == (["train.step"] + want) * 2
    for s in steps:
        assert _inside(rec, s) == want


def test_prefetch_records_the_wait_and_the_producer_on_their_threads():
    """The stream is endless, as a training stream is: five batches are
    taken and the prefetch closed."""
    with _cpu_profiler():
        batches = prefetch(iter(range(100)), put=lambda b: b * 2, depth=2)
        got = [next(batches) for _ in range(5)]
        batches.close()
    assert got == [0, 2, 4, 6, 8]
    rec = profiling.recorded()
    main = threading.get_native_id()
    feed = [s for s in rec.spans if s.name == "train.feed"]
    produce = [s for s in rec.spans if s.name == "feed.produce"]
    assert len(feed) >= 5 and all(s.thread == main for s in feed)
    assert len(produce) >= 5
    assert {s.thread for s in produce} != {main}
    assert len({s.thread for s in produce}) == 1


# ------------------------------------------------------------- the join


def test_the_join_puts_idle_down_to_the_innermost_span():
    """Device intervals leave gaps [10, 30), [40, 60) and [70, 100) (ns);
    the window's edges before 0 and after 110 are not gaps.  On the main
    thread: A [5, 65) holding B [12, 20) and C [45, 50) holding D [46, 48);
    E [75, 90) from 72 on another thread is not attributed."""
    trace = Trace([("k", 0, 10), ("k", 30, 40), ("k", 35, 38),
                   ("k", 60, 70), ("k", 100, 110)], [], 2e-7)
    main, other = 1, 2
    spans = [Span("A", main, 5, 65), Span("B", main, 12, 20),
             Span("C", main, 45, 50), Span("D", main, 46, 48),
             Span("E", other, 72, 90), Span("F", main, 95, None)]
    by = join.idle_by_span(trace, spans, main)
    assert join.gaps(trace) == [(10, 30), (40, 60), (70, 100)]
    assert by == {"A": (2 + 10) + (5 + 10), "B": 8, "C": 3, "D": 2,
                  None: 30}
    assert sum(by.values()) == 20 + 20 + 30


def test_innermost_pieces_cover_each_instant_once():
    pieces = join.innermost([("A", 0, 10), ("B", 2, 5), ("C", 5, 8),
                             ("X", 20, 30)])
    assert pieces == [(0, 2, "A"), (2, 5, "B"), (5, 8, "C"), (8, 10, "A"),
                      (20, 30, "X")]


def test_a_store_that_dropped_spans_gives_no_reading(monkeypatch):
    """Past the bound the dropped spans' idle would land in no span, so the
    readers report nothing rather than a wrong split; with every span kept
    they report the idle (here all of it under none, the spans lying far
    from the synthetic trace's clock)."""
    def run():
        trace = Trace([("k", 0, 10), ("k", 30, 40)], [], 4e-8)
        return SimpleNamespace(trace=trace, counts={"steps": 2})

    with _cpu_profiler():
        for _ in range(3):
            with profiling.span("train.forward"):
                pass
    kept = run()
    assert join.idle_ns(kept, other_than=()) == 20
    assert join.per_step_ms(kept, other_than=()) == 20 * 1e-6 / 2
    profiling.clear()
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    with _cpu_profiler():
        for _ in range(3):
            with profiling.span("train.forward"):
                pass
    assert profiling.recorded().dropped == 1
    cut = run()
    assert join.idle_ns(cut, ["train.forward"]) is None
    assert join.window_share(cut, other_than=()) is None
    assert join.per_step_ms(cut, other_than=()) is None
