"""update_ms: device milliseconds a step inside the program's `update`
spans: everything after the gradient (h1's evidence scaling and CG
solve, the clamp, the optimizer) (spans.py)."""

from port_bench.spans import span_ms


def read(trace):
    return span_ms(trace, ("update",))
