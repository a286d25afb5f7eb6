"""step_gap_ms: device idle milliseconds a step inside the program's `step`
spans: each span's wall from its begin marker's end to its end marker's
start, less the union of the operations in it, markers left out
(spans.py)."""

from port_bench.spans import gap_ms


def read(trace):
    return gap_ms(trace, "step")
