"""Share of the card's bf16 peak: the synthesis operations of the audio the
window completed (true lengths, `work.student_flops_per_sample`) over the
traced window's seconds."""

from perfbench import work


def read(run):
    if run.trace is None or not run.counts.get("useful_samples"):
        return None
    ops = work.student_flops_per_sample(run.sizes) * run.counts["useful_samples"]
    return 100.0 * ops / (run.trace.window_s * work.PEAK_BF16_FLOPS)
