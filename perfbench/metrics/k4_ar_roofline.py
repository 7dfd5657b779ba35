"""Kernel 4's share of its roofline: the least time of the AR steps'
operations at the fp32 peak (the sampler stores its weights in bf16 and
computes in fp32) over the summed device time of the kernels named
below."""

from perfbench import work

KERNELS = ("ar_sampler_kernel", "ar_wide_kernel", "ar_generic_kernel",
           "ar_block_kernel")


def read(run):
    if run.trace is None or not run.counts.get("steps"):
        return None
    busy = run.trace.kernel_s(KERNELS)
    if busy <= 0:
        return None
    ops = work.ar_step_flops(run.sizes, run.counts["rows"]) * run.counts["steps"]
    return 100.0 * work.least_time(ops, 0.0, work.PEAK_FP32_FLOPS) / busy
