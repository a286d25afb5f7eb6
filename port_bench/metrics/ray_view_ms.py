"""ray_view_ms: device milliseconds a step inside the program's `ray`
spans, forward and backward: each ray view's take, its oracle queries,
bounce chains and the ray loss's tail, and their backward (spans.py)."""

from port_bench.spans import span_ms


def read(trace):
    return span_ms(trace, ("ray",))
