"""The program's device spans in a traced run: the shared reduction of the
span metrics' readers (metrics/ray_view_ms.py and the others).

The program brackets parts of its train step with marker kernels on the
step's stream: `span_<name>_kernel` opens span `name`, `span_end_kernel`
closes the innermost open span. Spans nest. This reads only the trace's
device operations (names and intervals) in start order: each operation
that is not a marker counts once toward every span name open at its start
(a name open twice, as when a checkpointed chunk reruns forward code
inside `backward`, counts once); markers count toward none. Every reader
returns None where the trace holds no marker (a program without spans)."""

from __future__ import annotations

import re

from port_bench.tracing import kernel_of, merged

_MARKER = re.compile(r"^span_(\w+)_kernel$")
END = "end"
ORACLE = frozenset({"pack_kernel", "candidates_kernel", "closest_hit_kernel"})


def marker(name: str):
    """The span a device operation's name opens, END for the closing
    marker, None for any other operation."""
    m = _MARKER.match(kernel_of(name))
    return m.group(1) if m else None


def walk(device):
    """(operations, spans) of a trace's device operations: operations as
    (open span names, outermost first; name; start; end) for every
    operation that is not a marker, spans as (name, its begin marker's
    end, its end marker's start) for every closed span. An end marker
    with no open span (the profile began inside one) closes nothing."""
    stack, ops, closed = [], [], []
    for name, s, e in sorted(device, key=lambda r: (r[1], r[2])):
        kind = marker(name)
        if kind is None:
            ops.append((tuple(n for n, _ in stack), name, s, e))
        elif kind == END:
            if stack:
                n, t0 = stack.pop()
                closed.append((n, t0, s))
        else:
            stack.append((kind, e))
    return ops, closed


def has_markers(trace) -> bool:
    return any(marker(n) is not None for n, _, _ in trace.device)


def span_ms(trace, names, kernels=None):
    """Device milliseconds a step of the operations that started while a
    span of `names` was open (each once), only those whose bare name is in
    `kernels` where it is given; None without markers."""
    if not has_markers(trace):
        return None
    names = set(names)
    ops, _ = walk(trace.device)
    us = sum(e - s for open_, name, s, e in ops
             if names.intersection(open_)
             and (kernels is None or kernel_of(name) in kernels))
    return us * 1e-3 / trace.steps


def gap_ms(trace, name="step"):
    """Device idle milliseconds a step inside the spans `name`: each span's
    wall from its begin marker's end to its end marker's start, less the
    union of the operations (markers left out) within it; None without
    markers."""
    if not has_markers(trace):
        return None
    ops, closed = walk(trace.device)
    idle = 0.0
    for n, t0, t1 in closed:
        if n != name:
            continue
        busy = merged([(max(s, t0), min(e, t1)) for _, _, s, e in ops
                       if e > t0 and s < t1])
        idle += (t1 - t0) - sum(b - a for a, b in busy)
    return idle * 1e-3 / trace.steps
