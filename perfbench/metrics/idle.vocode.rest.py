"""Share of the traced window in which the card sat idle while the host
was under no span of `vocode.cond`, `vocode.readback` or
`vocode.deemphasis`: the noise draws, the flows' launches, bucketing,
the group's slicing and the benchmark's loop.  With those three it sums
to the window's idle less its edges (`perfbench/spans.py`)."""

from perfbench import spans

NAMED = ("vocode.cond", "vocode.readback", "vocode.deemphasis")


def read(run):
    return spans.window_share(run, other_than=NAMED)
