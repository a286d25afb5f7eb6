"""solve_adjoint_ms: device milliseconds a step of the operations that
started inside the program's `solve` spans while a `backward` span was
open: the adjoint CG solve that takes the gradient in the vertices to the
gradient in the parameters, g_u = (I + lambda L)^-1 g_v (spans.py). None
where the trace holds no `solve` marker (a program without the span)."""

from port_bench.solves import solve_ms


def read(trace):
    return solve_ms(trace, "backward")
