"""Share of the traced window in which the card sat idle while the host
was inside `vocode.deemphasis` (the serial deemphasis filter over the
group's rows), by innermost span (`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    return spans.window_share(run, ["vocode.deemphasis"])
