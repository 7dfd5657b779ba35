"""Milliseconds a completed step of the traced window in which the card
sat idle while the host was under none of the spans the other
`idle.train.*` metrics read: the step's own time between them and the
benchmark's loop.  With them it sums to the window's idle less its edges
over its steps (`perfbench/spans.py`).

Read under the profiler, which adds to the host's cost of every launch:
that lands most on the launch-heavy spans (the optimizer's per-tensor
ops), so the reading overstates the untraced step's idle (PERF.md section
5).  A gain on the step's host work is claimed on `train_utt_per_s` and
the untraced `train.dispatch_ms`, never on an `idle.train.*` reading."""

from perfbench import spans

NAMED = ("train.feed", "train.prepare", "train.forward", "train.backward",
         "train.reduce", "train.norm", "train.update", "train.ema")


def read(run):
    return spans.per_step_ms(run, other_than=NAMED)
