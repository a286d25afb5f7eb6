"""scatter_ms: device milliseconds a step of the row scatter-add's kernels,
both routes."""

from port_bench.tracing import kernel_ms

KERNELS = ("scatter_cluster_kernel", "scatter_upfront_kernel",
           "scatter_pass_kernel", "scatter_reduce_kernel")


def read(trace):
    return kernel_ms(trace, KERNELS)
