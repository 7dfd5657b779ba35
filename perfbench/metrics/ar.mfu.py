"""Share of the card's bf16 peak: the AR steps' operations
(`work.ar_step_flops`, every row of every step the window sampled) over
the traced window's seconds."""

from perfbench import work


def read(run):
    if run.trace is None or not run.counts.get("steps"):
        return None
    ops = work.ar_step_flops(run.sizes, run.counts["rows"]) * run.counts["steps"]
    return 100.0 * ops / (run.trace.window_s * work.PEAK_BF16_FLOPS)
