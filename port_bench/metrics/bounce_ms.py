"""bounce_ms: device milliseconds a step of the bounce chain's and the ray-
loss tail's kernels, forward and backward."""

from port_bench.tracing import kernel_ms

KERNELS = ("bounce_fwd_kernel", "bounce_bwd_kernel", "ray_tail_fwd_kernel",
           "ray_tail_bwd_kernel")


def read(trace):
    return kernel_ms(trace, KERNELS)
