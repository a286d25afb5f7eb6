"""LOD schedules (port of drt_tpu/optimize/schedules.py; reference interp_L
/ interp_R, optim.py:147-153)."""

from __future__ import annotations


def interp_linear(start: float, end: float, it: int, num: int) -> float:
    if it > num - 1:
        raise ValueError(f"pass {it} is beyond the schedule's {num} passes")
    if num == 1:
        return start
    step = (end - start) / (num - 1)
    return it * step + start


def interp_reciprocal(start: float, end: float, it: int, num: int) -> float:
    """Reciprocal interpolation: dense near `end` (reference optim.py:152-153:
    remesh length and lr decay harmonically across passes)."""
    return 1.0 / interp_linear(1.0 / start, 1.0 / end, it, num)
