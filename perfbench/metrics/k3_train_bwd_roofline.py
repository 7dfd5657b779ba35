"""Kernel 3's share of its roofline: the least time of the gated layers'
backward with weight gradients (`work.gated_stack_bwd`) for every sample
the traced window trained, over the summed device time of kernel 3's
pieces named below."""

from perfbench import work

KERNELS = ("train_bwd_layer", "wgrad_gemm", "wgrad_reduce",
           "train_bwd_finalize")


def read(run):
    if run.trace is None or not run.counts.get("samples"):
        return None
    busy = run.trace.kernel_s(KERNELS)
    if busy <= 0:
        return None
    z = run.sizes
    ops, nbytes = work.gated_stack_bwd(
        z["residual_channels"], z["gate_channels"], z["skip_channels"],
        z["n_mels"], len(z["dilations"]), run.counts["samples"])
    return 100.0 * work.least_time(ops, nbytes, work.PEAK_BF16_FLOPS) / busy
