"""The launch layer of drt_tpu_torch/kernels.py on the CPU: `launch` against
a stub library and a stub stream, `expect`, `on_device` and the typed rows.
The kernels themselves run in tests/test_torch_cuda.py, on the card."""

import contextlib
import types

import pytest
import torch

from drt_tpu_torch import kernels


class _Recorder:
    """A library whose every launch records its arguments and returns
    `err`."""

    def __init__(self, err=0):
        self.calls, self.err = [], err
        for name in kernels.LAUNCHES:
            setattr(self, f"{name}_launch",
                    lambda *a, name=name: self._record(name, a))

    def _record(self, name, args):
        self.calls.append((name, args))
        return self.err

    def drt_error_string(self, err):
        return b"stub error"


@pytest.fixture
def card(monkeypatch):
    """`launch` on CPU tensors: the library a recorder, the current stream
    a stub whose handle is 77."""
    lib = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    return lib


def _ray_order_args():
    dirs = torch.zeros(5, 3)
    return dict(dirs=dirs, dir_f64=False, n_rays=5, np=8,
                order=torch.zeros(8, dtype=torch.int32), scratch=None)


def test_launch_passes_the_row_in_order(card):
    """Arguments by name go out in the row's order: a tensor as its data
    pointer, None as NULL, a bool as an int, `stream` the current
    stream's handle; ctypes takes each as the row's type."""
    args = _ray_order_args()
    before = kernels.counters.snapshot()
    kernels.launch("ray_order", args["dirs"], ("launches",), **args)
    (name, got), = card.calls
    names, kinds = kernels.ROWS["ray_order"]
    assert name == "ray_order" and len(got) == len(names)
    want = dict(args, dirs=args["dirs"].data_ptr(),
                order=args["order"].data_ptr(), stream=77)
    assert dict(zip(names, got)) == want
    for value, kind in zip(got, kinds):
        kind(value)
    after = kernels.counters.snapshot()
    assert after["launches"] == before["launches"] + 1
    assert {k: v for k, v in after.items() if k != "launches"} == {
        k: v for k, v in before.items() if k != "launches"}


@pytest.mark.parametrize("change", ["missing", "extra", "stream"])
def test_launch_refuses_names_not_in_the_row(card, change):
    args = _ray_order_args()
    if change == "missing":
        del args["np"]
    elif change == "extra":
        args["n_pad"] = 8
    else:
        args["stream"] = 0
    with pytest.raises(TypeError, match="ray_order_launch"):
        kernels.launch("ray_order", args["dirs"], **args)
    assert card.calls == []


def test_launch_raises_on_a_cuda_error_and_counts_nothing(card):
    card.err = 700
    before = kernels.counters.snapshot()
    with pytest.raises(RuntimeError, match="ray_order launch failed: stub "
                                           r"error \(700\)"):
        kernels.launch("ray_order", torch.zeros(1), ("launches",),
                       what="ray_order", **_ray_order_args())
    with pytest.raises(RuntimeError, match="^ray order launch failed"):
        kernels.launch("ray_order", torch.zeros(1), **_ray_order_args())
    assert kernels.counters.snapshot() == before


@pytest.mark.parametrize("name", sorted(kernels.LAUNCHES))
def test_every_row_is_typed_and_ends_in_its_stream(name):
    """A row is `name:type` words of _CTYPES, its names distinct; every
    launch but the span marker (kind stream node) takes the stream last."""
    names, kinds = kernels.ROWS[name]
    assert len(names) == len(kinds) == len(kernels.LAUNCHES[name].split())
    assert len(set(names)) == len(names)
    assert all(k in kernels._CTYPES.values() for k in kinds)
    assert "stream" in names
    assert names[-1] == "stream" or name == "span_mark"


@pytest.mark.parametrize("case, match", [
    ("shape", r"x: expected \[4, 3\] float32, got \[4, 2\]"),
    ("rank", "x: expected"),
    ("dtype", "float32 or float64"),
    ("device", "x is on meta"),
    ("contiguous", "x must be contiguous"),
])
def test_expect_refuses(case, match):
    t = torch.zeros(4, 3)
    shape, dtype, device = (4, 3), torch.float32, torch.device("cpu")
    if case == "shape":
        t = torch.zeros(4, 2)
    elif case == "rank":
        t = torch.zeros(4, 3, 1)
    elif case == "dtype":
        t, dtype = t.half(), (torch.float32, torch.float64)
    elif case == "device":
        t = t.to("meta")
    else:
        t = torch.zeros(3, 4).t()
    with pytest.raises(ValueError, match=match):
        kernels.expect("x", t, shape, dtype, device)


def test_expect_takes_wildcards_choices_and_none():
    cpu = torch.device("cpu")
    kernels.expect("x", torch.zeros(7, 3), (None, 3), torch.float32, cpu)
    kernels.expect("x", torch.zeros(2, dtype=torch.float64), (2,),
                   (torch.float32, torch.float64), cpu)
    kernels.expect("x", None, (2,), torch.int64, cpu)
    kernels.expect("x", torch.zeros(()), (), torch.float32, cpu)


def test_on_device_and_need_cuda():
    def cuda():
        return "cuda"

    def plain():
        return "plain"
    assert kernels.on_device(torch.zeros(1), cuda, plain) is plain
    with pytest.raises(ValueError, match="unsupported device meta"):
        kernels.on_device(torch.zeros(1, device="meta"), cuda, plain)
    with pytest.raises(ValueError, match="f needs CUDA tensors"):
        kernels.need_cuda("f", torch.zeros(1))


def test_checks_refuse_an_unknown_launch():
    with pytest.raises(ValueError, match="no launch"):
        kernels.checks("bounce", "bounse")
