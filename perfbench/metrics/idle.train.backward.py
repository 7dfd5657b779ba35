"""Milliseconds a completed step of the traced window in which the card
sat idle while the host was inside `train.backward` (`autograd.grad`),
by innermost span (`perfbench/spans.py`).

Read under the profiler, which adds to the host's cost of every launch:
that lands most on the launch-heavy spans (the optimizer's per-tensor
ops), so the reading overstates the untraced step's idle (PERF.md section
5).  A gain on the step's host work is claimed on `train_utt_per_s` and
the untraced `train.dispatch_ms`, never on an `idle.train.*` reading."""

from perfbench import spans


def read(run):
    return spans.per_step_ms(run, ["train.backward"])
