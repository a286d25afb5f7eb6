"""torch_ops_ms: device milliseconds a step of every operation that is not
one of the port's own kernels (its csrc/*.cu): PyTorch's kernels, copies
and fills, those of the trace's, silhouette's and losses' torch chains,
the normals, autograd's sums and the update."""


def read(trace):
    ms = sum(e - s for n, s, e in trace.device
             if _bare(n) not in trace.kernels)
    return ms * 1e-3 / trace.steps


def _bare(name):
    from port_bench.tracing import kernel_of
    return kernel_of(name)
