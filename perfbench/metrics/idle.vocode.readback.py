"""Share of the traced window in which the card sat idle while the host
was inside `vocode.readback` (the group's `.cpu().numpy()`: waiting on the
flows, then the copy to pageable memory), by innermost span
(`perfbench/spans.py`)."""

from perfbench import spans


def read(run):
    return spans.window_share(run, ["vocode.readback"])
