"""solve_forward_ms: device milliseconds a step of the operations that
started inside the program's `solve` spans while a `normals` span was
open: the Sobolev parameterisation's CG solve of the vertices from the
parameters, v = (I + lambda L)^-1 u (spans.py). None where the trace
holds no `solve` marker (a program without the span)."""

from port_bench.solves import solve_ms


def read(trace):
    return solve_ms(trace, "normals")
