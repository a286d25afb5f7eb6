"""Spans of the train step on the device clock.

A span is a pair of marker kernels (csrc/span.cu) on the step's stream:
`span_<name>_kernel` opens span `name`, `span_end_kernel` closes the
innermost open one, so the profiler's device trace shows each span between
the operations it brackets, on their clock, in an eager step and in a
replay of the step's CUDA graph alike (a replay runs no Python, so a host
range would be missing there). One step is one `step` span; inside it:

- forward, `normals` (the parameters-to-vertices map and
  `MeshState.with_vertices`), `ray` (each ray view's take and `ray_loss`),
  `silhouette` (the silhouette views' chains and queries),
  `smooth` (`smooth_loss`);
- `backward` around `torch.autograd.grad`, and inside it each chain's
  backward segment under the chain's name: opened by a pre-hook on the
  chain's output node (`chain_output`) and closed by a hook on the chain's
  own view of its input (`chain_input`), which fires once that chain's
  gradient is complete;
- `update`: everything after the gradient (h1's evidence scaling and CG
  solve, the clamp, the optimizer, `silh_max`);
- `solve`: each CG solve of `optimize/precondition.sobolev_solve`, inside
  whichever span launches it: the Sobolev parameterisation's solve of the
  vertices inside `normals`, its adjoint solve of the gradient inside
  `backward`, h1's solve inside `update`.

A step of uadam + h1 takes the gradient twice and so opens the forward and
backward spans once a pass.

Switch: whether a torch profiler is recording. With none, a span costs a
test on the host and launches nothing. A capture of the step
(`GraphedTrainStep`, inside `capturing`) always records the markers and
keeps their graph nodes; the graph's owner disables them after
`instantiate` and enables them for the replays that a profiler records
(`set_enabled`), with no new capture. The chains' views (`chain_input`)
are taken whether or not spans are on, so a step's numbers do not depend
on the switch. On CPU tensors nothing is launched.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd import profiler as _profiler

from drt_tpu_torch import kernels

# The span names, in the order of csrc/span.cu's kinds; "end" closes.
NAMES = ("step", "normals", "ray", "silhouette", "smooth", "backward",
         "update", "solve")
_KIND = {name: i for i, name in enumerate(NAMES + ("end",))}

# The graph nodes of the markers launched while a step is being captured
# (a list, inside `capturing`), else None.
_capture_nodes = None
# `step` spans open: the graph wrapper's step span holds the eager step's.
_steps_open = 0


def recording() -> bool:
    """Whether a torch profiler is recording: the spans' switch."""
    return _profiler._is_profiler_enabled


def _on() -> bool:
    return _capture_nodes is not None or _profiler._is_profiler_enabled


def _emit(name: str, edge: str, device: torch.device):
    """Launch the marker that opens (edge "begin") or closes (edge "end")
    span `name` on `device`'s current stream; nothing on the CPU."""
    if device.type != "cuda":
        return
    node = ctypes.c_void_p()
    kernels.launch("span_mark", device, what=f"span marker ({name}, {edge})",
                   kind=_KIND[name if edge == "begin" else "end"],
                   node=ctypes.byref(node))
    if node.value and _capture_nodes is not None:
        _capture_nodes.append(node.value)


class span:
    """`with span(name, at):` brackets the block's device work on `at`'s
    device as span `name` while spans are on."""

    __slots__ = ("name", "device")

    def __init__(self, name: str, at: torch.Tensor):
        self.name, self.device = name, at.device

    def __enter__(self):
        if not _on():
            self.device = None
            return self
        _emit(self.name, "begin", self.device)
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            _emit(self.name, "end", self.device)
        return False


class step_span(span):
    """The `step` span: one a step, however many callers open it (the
    graph wrapper's, around its row selection and state copy, holds the
    eager step's own)."""

    __slots__ = ()

    def __init__(self, at: torch.Tensor):
        super().__init__("step", at)

    def __enter__(self):
        global _steps_open
        _steps_open += 1
        if _steps_open > 1:
            self.device = None
            return self
        return super().__enter__()

    def __exit__(self, *exc):
        global _steps_open
        _steps_open -= 1
        return super().__exit__(*exc)


def chain_input(name: str, x: torch.Tensor) -> torch.Tensor:
    """A view of `x` that chain `name` alone reads. While spans are on, the
    chain's backward segment closes when the view's gradient is complete,
    which is when every operation of the chain that reads it has run
    backward."""
    alias = x.view_as(x)
    if alias.requires_grad and _on():
        device = x.device
        alias.register_hook(lambda g: _emit(name, "end", device))
    return alias


def chain_output(name: str, y: torch.Tensor) -> torch.Tensor:
    """`y`, the output of chain `name`. While spans are on, the chain's
    backward segment opens when y's autograd node starts to run."""
    if y.grad_fn is not None and _on():
        device = y.device
        y.grad_fn.register_prehook(lambda grads: _emit(name, "begin",
                                                       device))
    return y


class capturing:
    """`with capturing() as nodes:` around a capture of the step: the
    markers are launched (so captured) whether or not a profiler records,
    and `nodes` gets their graph nodes, for `set_enabled`."""

    def __enter__(self) -> list:
        global _capture_nodes
        if _capture_nodes is not None:
            raise RuntimeError("spans.capturing: a capture is in progress")
        _capture_nodes = []
        return _capture_nodes

    def __exit__(self, *exc):
        global _capture_nodes
        _capture_nodes = None
        return False


def set_enabled(graph: torch.cuda.CUDAGraph, nodes: list, enabled: bool):
    """Switch the marker nodes `nodes` of the instantiated `graph` (kept by
    `keep_graph=True`) on or off for its next replays, in one call."""
    if not nodes:
        return
    lib = kernels.load()
    arr = (ctypes.c_void_p * len(nodes))(*nodes)
    kernels.check(lib, lib.span_nodes_set_enabled(
        ctypes.c_void_p(graph.raw_cuda_graph_exec()), arr, len(nodes),
        int(enabled)), "span markers' switch")
