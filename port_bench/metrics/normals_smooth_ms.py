"""normals_smooth_ms: device milliseconds a step inside the program's
`normals` and `smooth` spans, forward and backward: the parameters-to-
vertices map, the vertex normals and the smoothness term (spans.py)."""

from port_bench.spans import span_ms


def read(trace):
    return span_ms(trace, ("normals", "smooth"))
