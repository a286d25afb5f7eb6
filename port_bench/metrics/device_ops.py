"""device_ops: device operations (kernels, copies, fills) a step."""


def read(trace):
    return len(trace.device) / trace.steps
