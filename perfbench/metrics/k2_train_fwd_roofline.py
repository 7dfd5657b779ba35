"""Kernel 2's share of its roofline: the least time of the gated layers'
training forward, saving each layer's input (`work.gated_stack_fwd`), for
every sample the traced window trained, over the summed device time of
the kernel that computes it (kernel 5's accumulate epilogue, named
below; in this cell nothing else launches it)."""

from perfbench import work

KERNELS = ("gated_layer_kernel",)


def read(run):
    if run.trace is None or not run.counts.get("samples"):
        return None
    busy = run.trace.kernel_s(KERNELS)
    if busy <= 0:
        return None
    z = run.sizes
    ops, nbytes = work.gated_stack_fwd(
        z["residual_channels"], z["gate_channels"], z["skip_channels"],
        z["n_mels"], len(z["dilations"]), run.counts["samples"],
        save_inputs=True)
    return 100.0 * work.least_time(ops, nbytes, work.PEAK_BF16_FLOPS) / busy
