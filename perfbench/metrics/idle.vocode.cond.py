"""Share of the traced window in which the card sat idle while the host
was inside `vocode.cond` (the group's mels padded, stacked and uploaded,
the upsampler and its tail splice launched), by innermost span on the
thread that issues the card's work (`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    return spans.window_share(run, ["vocode.cond"])
