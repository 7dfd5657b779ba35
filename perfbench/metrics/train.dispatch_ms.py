"""The median host-clock milliseconds the benchmark's own span around each
train-step call took, in the stretch of steps a traced run makes before
its profiler starts: the step's host work up to the return of the call
(the card runs on after it), with nothing of the profiler in it."""

import statistics


def read(run):
    spans = run.spans.get("train_step")
    if not spans:
        return None
    return 1e3 * statistics.median(spans)
