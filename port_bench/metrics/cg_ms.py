"""cg_ms: device milliseconds a step of the Sobolev CG solve's kernels, both
routes."""

from port_bench.tracing import kernel_ms

KERNELS = ("cg_kernel", "cg_shared_kernel")


def read(trace):
    return kernel_ms(trace, KERNELS)
