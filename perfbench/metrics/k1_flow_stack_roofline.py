"""Kernel 1's share of its roofline: the least time of the flow stacks'
gated layers over the audio the window completed (true lengths; every
flow; bf16 peak or HBM bytes, the larger) over the summed device time of
the kernels named below."""

from perfbench import work

KERNELS = ("flow_stack_kernel",)


def read(run):
    if run.trace is None or not run.counts.get("useful_samples"):
        return None
    busy = run.trace.kernel_s(KERNELS)
    if busy <= 0:
        return None
    z = run.sizes
    ops, nbytes = work.gated_stack_fwd(
        z["residual_channels"], z["gate_channels"], z["skip_channels"],
        z["n_mels"], z["layers_per_flow"],
        run.counts["useful_samples"] * z["n_flows"])
    return 100.0 * work.least_time(ops, nbytes, work.PEAK_BF16_FLOPS) / busy
