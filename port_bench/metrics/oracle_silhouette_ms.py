"""oracle_silhouette_ms: device milliseconds a step of the oracle's three
kernels (pack, candidate prepass, closest hit) inside the program's
`silhouette` spans: the silhouette views' queries (spans.py)."""

from port_bench.spans import ORACLE, span_ms


def read(trace):
    return span_ms(trace, ("silhouette",), ORACLE)
