"""The program's CG solves in a traced run, by the span that launched
them: the shared reduction of metrics/solve_forward_ms.py and
metrics/solve_adjoint_ms.py over port_bench/spans.py's walk.

A solve of `optimize/precondition.sobolev_solve` is a `solve` span inside
the span of its caller: the Sobolev parameterisation's solve of the
vertices inside `normals`, its adjoint solve of the gradient inside
`backward`, h1's solve inside `update`."""

from __future__ import annotations

from port_bench.spans import marker, walk

SOLVE = "solve"


def solve_ms(trace, outer: str):
    """Device milliseconds a step of the operations that started while a
    `solve` span and a span `outer` were both open; None where the trace
    holds no `solve` marker (a program without the span)."""
    if not any(marker(n) == SOLVE for n, _, _ in trace.device):
        return None
    ops, _ = walk(trace.device)
    us = sum(e - s for open_, _, s, e in ops
             if SOLVE in open_ and outer in open_)
    return us * 1e-3 / trace.steps
