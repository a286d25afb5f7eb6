"""silhouette_views_ms: device milliseconds a step inside the program's
`silhouette` spans, forward and backward: the silhouette views' takes,
their oracle queries and edge chains, and their backward (spans.py)."""

from port_bench.spans import span_ms


def read(trace):
    return span_ms(trace, ("silhouette",))
