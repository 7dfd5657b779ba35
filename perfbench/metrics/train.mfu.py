"""Share of the card's bf16 peak: three times the teacher's forward
operations (`work.teacher_fwd_flops_per_sample`) for every sample trained
in the untraced stretch of steps a traced run makes before its profiler
starts, over that stretch's host-clock seconds (the profiler slows this
host-bound step, so the traced window's rate is not the step's)."""

from perfbench import work


def read(run):
    if not run.counts.get("untraced_steps"):
        return None
    samples = run.counts["untraced_steps"] * run.counts["samples_per_step"]
    ops = 3.0 * work.teacher_fwd_flops_per_sample(run.sizes) * samples
    return 100.0 * ops / (run.counts["untraced_s"] * work.PEAK_BF16_FLOPS)
