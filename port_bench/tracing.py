"""The traced run's reduction: the profiler's device and host events, the
device's busy time (the union of its operations' intervals), the trace's
breakdown, and the port's kernel names, read from its CUDA sources."""

from __future__ import annotations

import glob
import os
import re
from typing import NamedTuple

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


class Trace(NamedTuple):
    """What a per-layer metric's reader reads."""
    device: list          # [(name, start_us, end_us)] device operations
    host: list            # [(name, start_us, end_us)] host operations
    steps: int            # steps (or passes) in the traced window
    window_s: float       # the traced window's length, host clock
    busy_s: float         # union of the device operations' intervals
    config: dict          # the cell's configuration
    mix: dict             # its traffic mix
    mesh: tuple           # (vertices, faces) of the mesh the step runs on
    kernels: frozenset    # the port's kernel names (its csrc/*.cu)


def port_kernels(package_dir: str) -> frozenset:
    names = set()
    for path in glob.glob(os.path.join(package_dir, "csrc", "*.cu")):
        with open(path) as fh:
            names.update(_GLOBAL.findall(fh.read()))
    return frozenset(names)


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: 'void cg_shared_kernel<float, 6>(...)' ->
    'cg_shared_kernel'."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    if base.startswith("void "):
        base = base[5:]
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


def kernel_of(name: str) -> str:
    """The bare function name of a device operation (the last component of
    its short name)."""
    return short_name(name).split("::")[-1]


def kernel_ms(trace: Trace, names) -> float | None:
    """Device milliseconds a step of the operations whose bare function
    name is one of `names`; None where none of them ran."""
    names = set(names)
    found = [e - s for n, s, e in trace.device if kernel_of(n) in names]
    if not found:
        return None
    return sum(found) * 1e-3 / trace.steps


def collect(prof):
    """(device events, host events) of a torch.profiler run."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if not e.is_user_annotation:
                device.append(row)
        else:
            host.append(row)
    return device, host


def merged(intervals):
    """The union of [(start, end)] as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(device) -> float:
    return sum(e - s for s, e in merged([(s, e) for _, s, e in device]))


def breakdown(device, host, t0_us: float, t1_us: float) -> dict:
    """The ten device operations that took most time (by bare name, in
    seconds) and the ten longest idle gaps of the device within [t0, t1],
    each named by the innermost host operation running at its middle."""
    by = {}
    for name, s, e in device:
        k = kernel_of(name) or name
        by[k] = by.get(k, 0.0) + (e - s) * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    busy = merged([(max(s, t0_us), min(e, t1_us)) for _, s, e in device
                   if e > t0_us and s < t1_us])
    gaps, prev = [], t0_us
    for s, e in busy + [[t1_us, t1_us]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        cover = [(hs, name) for name, hs, he in host if hs <= mid <= he]
        label = max(cover)[1] if cover else "host outside any operation"
        named.append([label, (e - s) * 1e-6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
