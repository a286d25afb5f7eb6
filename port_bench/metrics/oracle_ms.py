"""oracle_ms: device milliseconds a step of the oracle's three kernels
(pack, candidate prepass, closest hit)."""

from port_bench.tracing import kernel_ms

KERNELS = ("pack_kernel", "candidates_kernel", "closest_hit_kernel")


def read(trace):
    return kernel_ms(trace, KERNELS)
