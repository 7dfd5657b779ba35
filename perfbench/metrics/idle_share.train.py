"""Share of an untraced train step in which no operation ran on the card:
one minus the device's busy seconds a step in the traced window (the
union of device intervals over the steps it completed) over the step's
host-clock seconds in the untraced stretch before the profiler started.
The profiler slows the host-bound step but not the card's operations, so
the traced window's own idle share counts the profiler's cost as idle."""


def read(run):
    if (run.trace is None or not run.counts.get("steps")
            or not run.counts.get("untraced_steps")):
        return None
    busy_per_step = run.trace.busy_s / run.counts["steps"]
    step_s = run.counts["untraced_s"] / run.counts["untraced_steps"]
    return 100.0 * (1.0 - busy_per_step / step_s)
