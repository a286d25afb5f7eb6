"""The train step's device spans (drt_tpu_torch/spans.py, csrc/span.cu) and
the benchmark's reduction of them (port_bench/spans.py).

On the CPU, on a tiny mesh, with the span emitter patched to record
(name, edge): an eager sgd + none and an eager uadam + h1 step emit
properly nested spans in the step's order, each chain's backward segment
inside `backward`; each custom autograd Function's backward runs inside
its own chain's segment; with the profiler off nothing is emitted and
the step's loss and parameters are the bits of a step with spans on; each
CG solve is a `solve` span inside its caller's. The readers of
port_bench/spans.py and port_bench/solves.py on synthetic device traces,
and `tracing.port_kernels` against the markers of csrc/span.cu.

Marked `cuda` (skip without a card; on the card run this file with
`--noconftest`, as tests/test_torch_cuda.py): after the capture the
marker nodes are disabled, replays with markers on and off give the same
bits, switching needs no new capture, and with markers on the profiler
shows them in the step's order, eager and replayed; the adjoint solves
are counted. No JAX here."""

import os
import re

import pytest
import torch

from drt_tpu_torch import kernels, spans
from drt_tpu_torch.data.synthetic import synthesize_capture
from drt_tpu_torch.geometry import scatter as SC
from drt_tpu_torch.intersect import get_intersect_fn
from drt_tpu_torch.mesh import build_mesh_state
from drt_tpu_torch.optimize import LossWeights, make_train_step
from drt_tpu_torch.render import bounce as BO
from drt_tpu_torch.render import silhouette_kernels as SK
from drt_tpu_torch.render import trace as TR
# pytest puts tests/ on sys.path; `tests.meshes` could resolve to another
# installed package named `tests` on a GPU machine.
from meshes import make_icosphere
from port_bench import spans as PS
from port_bench import tracing

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (24, 32)
WEIGHTS = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
RAY = [1]
SILH = [0, 1, 2, 3, 0, 1, 2, 3]
CASES = [("sgd", "none"), ("uadam", "h1"), ("uadam", "sobolev")]


def _b(name):
    return (name, "begin")


def _e(name):
    return (name, "end")


def _fwd(*names):
    return [x for n in names for x in (_b(n), _e(n))]


def _around(outer, *inner):
    return [_b(outer)] + _fwd(*inner) + [_e(outer)]


# The step's spans in order (spans.py): nothing reads the vertex normals'
# value in the loss, so `normals` has no backward segment. Each CG solve is
# a `solve` span inside its caller's: h1's inside `update`; the Sobolev
# parameterisation's solve of the vertices inside `normals`, and its
# adjoint inside `backward`, after every chain's segment, since it takes
# the vertices' whole gradient.
ORDER = {
    ("sgd", "none"): (
        [_b("step")] + _fwd("normals", "ray", "silhouette", "smooth")
        + [_b("backward")] + _fwd("smooth", "silhouette", "ray")
        + [_e("backward")] + _fwd("update") + [_e("step")]),
    ("uadam", "h1"): (
        [_b("step")] + _fwd("normals", "ray") + [_b("backward")]
        + _fwd("ray") + [_e("backward")]
        + _fwd("normals", "silhouette", "smooth") + [_b("backward")]
        + _fwd("smooth", "silhouette") + [_e("backward")]
        + _around("update", "solve") + [_e("step")]),
    ("uadam", "sobolev"): (
        [_b("step")] + _around("normals", "solve")
        + _fwd("ray", "silhouette", "smooth")
        + [_b("backward")] + _fwd("smooth", "silhouette", "ray", "solve")
        + [_e("backward")] + _fwd("update") + [_e("step")]),
}


@pytest.fixture(scope="module")
def tiny():
    gv, gf = make_icosphere(subdivisions=2, radius=50.0)
    cap = synthesize_capture(gv, gf, num_views=4, resy=RES[0],
                             resx=RES[1], ior=1.5, device="cpu")
    v0, f0 = make_icosphere(subdivisions=2, radius=47.0)
    return build_mesh_state(v0, f0, device="cpu"), cap.views


def _step(case):
    init, step, _ = make_train_step(get_intersect_fn("auto"), WEIGHTS,
                                    *RES, 256, optimizer=case[0],
                                    precond=case[1])
    return init, step


@pytest.fixture
def record(monkeypatch):
    """The emitted (name, edge) pairs, in order, instead of markers."""
    log = []
    monkeypatch.setattr(spans, "_emit",
                        lambda name, edge, device: log.append((name, edge)))
    return log


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _nested(log):
    """Whether every end closes the innermost open span of its name; the
    greatest depth."""
    stack, depth = [], 0
    for name, edge in log:
        if edge == "begin":
            stack.append(name)
            depth = max(depth, len(stack))
        elif not stack or stack.pop() != name:
            return False, depth
    return not stack, depth


@pytest.mark.parametrize("case", CASES, ids="+".join)
def test_eager_step_emits_nested_spans_in_order(tiny, record, case):
    ms, views = tiny
    init, step = _step(case)
    _profiled(lambda: step(init(ms), 0.01, ms, views, RAY, SILH))
    assert record == ORDER[case]
    ok, depth = _nested(record)
    assert ok and depth == 3          # step > backward > chain


@pytest.mark.parametrize("case", CASES, ids="+".join)
def test_spans_off_emit_nothing_and_change_no_bits(tiny, record, case):
    ms, views = tiny
    init, step = _step(case)
    off = step(init(ms), 0.01, ms, views, RAY, SILH)
    assert record == []
    on = _profiled(lambda: step(init(ms), 0.01, ms, views, RAY, SILH))
    assert len(record) == len(ORDER[case])
    assert torch.equal(off[1], on[1])
    for k in off[0]:
        assert torch.equal(off[0][k], on[0][k]), k


# Each custom autograd Function of the step and the chain its backward
# belongs to (None: the chain that called it, whichever it is).
FUNCTIONS = [(SK._SilhouetteView, "silhouette"), (TR._GatherTri9, "ray"),
             (BO._BounceChain, "ray"), (BO._RayLossTail, "ray"),
             (SC._GatherRows, None)]


def test_custom_backwards_run_inside_their_chain(tiny, record, monkeypatch):
    """Every custom Function's backward, and every scatter that a backward
    runs, runs inside a chain's backward segment (never in `backward`
    alone), its own chain's where it has one."""
    ms, views = tiny
    seen = []

    def stack():
        out = []
        for name, edge in record:
            out.append(name) if edge == "begin" else out.pop()
        return tuple(out)

    def wrap(fn, real):
        def backward(ctx, *grads):
            seen.append((fn, stack()))
            return real(ctx, *grads)
        return staticmethod(backward)
    for fn, _ in FUNCTIONS:
        monkeypatch.setattr(fn, "backward", wrap(fn, fn.backward))
    real_scatter = SC._scatter

    def scatter(*args):
        seen.append(("scatter", stack()))
        return real_scatter(*args)
    monkeypatch.setattr(SC, "_scatter", scatter)
    init, step = _step(("sgd", "none"))
    _profiled(lambda: step(init(ms), 0.01, ms, views, RAY, SILH))
    chains = {"ray", "silhouette", "smooth", "normals"}
    assert {fn for fn, _ in seen} == {fn for fn, _ in FUNCTIONS} | {"scatter"}
    scatters = [st for fn, st in seen if fn == "scatter" and "backward" in st]
    # the ray view's two bounces (two each), the 8 silhouette views and
    # the dihedral term
    assert len(scatters) == 2 * 2 + 8 + 1
    for fn, st in seen:
        if fn == "scatter" and "backward" not in st:
            continue              # the forward's (the vertex normals)
        want = dict(FUNCTIONS).get(fn)
        assert st[:2] == ("step", "backward") and len(st) == 3, (fn, st)
        assert st[2] in chains and st[2] == (want or st[2]), (fn, st)


def test_step_span_is_one_however_many_open_it(record):
    at = torch.zeros(1)
    _profiled(lambda: _two_step_spans(at))
    assert record == [_b("step"), _b("update"), _e("update"), _e("step")]
    assert spans._steps_open == 0


def _two_step_spans(at):
    with spans.step_span(at):
        with spans.step_span(at):
            with spans.span("update", at):
                pass


def test_emit_on_the_cpu_launches_nothing(monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("loaded"))
    spans._emit("ray", "begin", torch.device("cpu"))


def test_capturing_keeps_nodes_and_refuses_nesting():
    with spans.capturing() as nodes:
        assert nodes == [] and spans._on()
        with pytest.raises(RuntimeError, match="in progress"):
            spans.capturing().__enter__()
    assert spans._capture_nodes is None and not spans._on()


# -- csrc/span.cu and the port's kernel names -------------------------------

def _source():
    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                           "span.cu")) as fh:
        return fh.read()


def test_markers_follow_the_table():
    """csrc/span.cu has one plain `span_<name>_kernel` a span name and
    `span_end_kernel`, in the table's order, which is spans.NAMES;
    `tracing.port_kernels` finds each, so `torch_ops_ms` leaves them
    out."""
    src = _source()
    kinds = kernels.SPAN_KINDS.split()
    assert kinds == list(spans.NAMES) + ["end"]
    m = re.search(r'span_kinds_signature\(\) \{\s*return ((?:"[^"]*"\s*)+);',
                  src)
    assert "".join(re.findall(r'"([^"]*)"', m.group(1))).split() == kinds
    table = re.search(r"MARKERS\[\] = \{([^}]*)\}", src).group(1)
    assert re.findall(r"span_(\w+)_kernel", table) == kinds
    found = tracing.port_kernels(os.path.join(ROOT, "drt_tpu_torch"))
    for k in kinds:
        assert f"span_{k}_kernel" in found
        assert PS.marker(f"void span_{k}_kernel()") == k
        assert re.search(rf"__global__ void span_{k}_kernel\(\) \{{\}}", src)
    m = re.search(r'span_signature\(\) \{ return "([^"]*)"', src)
    assert m.group(1).split() == list(kernels.ROWS["span_mark"][0])
    assert len(kernels.ROWS["span_mark"][1]) == 3


# -- port_bench/spans.py on synthetic device traces -------------------------

def _trace(device, steps=1):
    return tracing.Trace(device=device, host=[], steps=steps, window_s=1.0,
                         busy_s=0.0, config={}, mix={}, mesh=(0, 0),
                         kernels=frozenset())


def _ops(*rows):
    """Device rows from (name, start, end): a span name alone is its
    begin marker, "/" the end marker (each 1 us long)."""
    out = []
    for name, s, e in rows:
        if name == "/":
            name = "void span_end_kernel()"
        elif name in spans.NAMES:
            name = f"void span_{name}_kernel()"
        out.append((name, float(s), float(e)))
    return out


def test_readers_without_markers_read_none():
    tr = _trace(_ops(("void closest_hit_kernel<1>(int)", 0, 40),
                     ("Memset (Device)", 50, 60)))
    for name in ("ray_view_ms", "silhouette_views_ms", "oracle_silhouette_ms",
                 "normals_smooth_ms", "update_ms", "step_gap_ms"):
        assert _reader(name)(tr) is None, name


def _reader(name):
    from port_bench import bench
    return bench.metric_reader(name, ROOT)


NESTED = _ops(
    ("step", 0, 1),
    ("elementwise_kernel", 2, 4),                 # step self: 2
    ("silhouette", 4, 5),
    ("void closest_hit_kernel<1>(int)", 5, 15),   # 10
    ("reduce_kernel", 15, 18),                    # 3
    ("/", 18, 19),
    ("backward", 19, 20),
    ("silhouette", 20, 21),
    ("void pack_kernel(int)", 21, 22),            # 1 (a rerun query)
    ("scatter_cluster_kernel", 25, 29),           # 4, after a gap of 3
    ("/", 29, 30),
    ("ray", 30, 31),
    ("ray", 31, 32),                              # a chunk's rerun forward
    ("bounce_bwd_kernel", 32, 37),                # 5: counts once
    ("/", 37, 38),
    ("/", 38, 39),
    ("/", 39, 40),
    ("update", 40, 41),
    ("cg_shared_kernel", 41, 47),                 # 6
    ("/", 47, 48),
    ("/", 50, 51),                                # after a gap of 2
    ("Memcpy DtoD", 60, 61))                      # outside every span


def test_readers_on_nested_spans():
    tr = _trace(NESTED, steps=2)
    ms = {n: _reader(n)(tr) for n in (
        "ray_view_ms", "silhouette_views_ms", "oracle_silhouette_ms",
        "normals_smooth_ms", "update_ms", "step_gap_ms")}
    assert ms["silhouette_views_ms"] == pytest.approx((10 + 3 + 1 + 4)
                                                      * 1e-3 / 2)
    assert ms["oracle_silhouette_ms"] == pytest.approx(11e-3 / 2)
    assert ms["ray_view_ms"] == pytest.approx(5e-3 / 2)
    assert ms["update_ms"] == pytest.approx(6e-3 / 2)
    assert ms["normals_smooth_ms"] == 0.0
    # the step's wall 1..50 (49) less its operations (2+10+3+1+4+5+6 = 31)
    assert ms["step_gap_ms"] == pytest.approx((49 - 31) * 1e-3 / 2)
    ops, _ = PS.walk(tr.device)
    own = {}
    for open_, _, s, e in ops:
        if open_:
            own[open_[-1]] = own.get(open_[-1], 0.0) + e - s
    assert own == {"step": 2, "silhouette": 18, "ray": 5, "update": 6}
    assert PS.span_ms(tr, ("step",)) == pytest.approx(31e-3 / 2)


# A uadam + sobolev step's solves (port_bench/solves.py): the vertices'
# solve inside `normals`, the adjoint inside `backward`; and h1's inside
# `update`, which neither metric reads.
SOLVES = _ops(
    ("step", 0, 1),
    ("normals", 1, 2),
    ("solve", 2, 3),
    ("void cg_shared_kernel<float, 12>(int)", 3, 10),     # 7
    ("/", 10, 11),
    ("elementwise_kernel", 11, 12),                         # normals: 1
    ("/", 12, 13),
    ("backward", 13, 14),
    ("silhouette", 14, 15),
    ("scatter_cluster_kernel", 15, 17),
    ("/", 17, 18),
    ("solve", 18, 19),
    ("void cg_shared_kernel<float, 12>(int)", 19, 28),    # 9
    ("Memset (Device)", 28, 29),                            # 1
    ("/", 29, 30),
    ("/", 30, 31),
    ("update", 31, 32),
    ("solve", 32, 33),
    ("void cg_shared_kernel<float, 12>(int)", 33, 38),    # 5
    ("/", 38, 39),
    ("/", 39, 40),
    ("/", 40, 41))


def test_solve_readers_split_the_solves_by_their_caller():
    tr = _trace(SOLVES, steps=2)
    assert _reader("solve_forward_ms")(tr) == pytest.approx(7e-3 / 2)
    assert _reader("solve_adjoint_ms")(tr) == pytest.approx((9 + 1) * 1e-3
                                                            / 2)
    assert _reader("update_ms")(tr) == pytest.approx(5e-3 / 2)
    assert _reader("normals_smooth_ms")(tr) == pytest.approx(8e-3 / 2)


def test_solve_readers_read_none_without_a_solve_marker():
    """A program with spans but no `solve` span (before it was added)
    gives no reading, not nought; nor does a trace without markers."""
    for trace in (NESTED, _ops(("void cg_shared_kernel<float, 6>(int)",
                                0, 40))):
        for name in ("solve_forward_ms", "solve_adjoint_ms"):
            assert _reader(name)(_trace(trace)) is None, name


def test_walk_counts_markers_toward_nothing_and_drops_a_stray_end():
    ops, closed = PS.walk(_ops(("/", 0, 1), ("ray", 1, 2),
                               ("reduce_kernel", 3, 4), ("/", 4, 5),
                               ("elementwise_kernel", 6, 7)))
    assert [(o[0], o[1]) for o in ops] == [(("ray",), "reduce_kernel"),
                                           ((), "elementwise_kernel")]
    assert closed == [("ray", 2.0, 4.0)]


def test_gap_reads_idle_time_between_overlapping_operations():
    tr = _trace(_ops(("step", 0, 1), ("a_kernel", 1, 5), ("b_kernel", 3, 8),
                     ("/", 10, 11)))
    assert PS.gap_ms(tr) == pytest.approx(2e-3)      # wall 9, busy 7


# -- on the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the markers have no CPU mode)")
    dev = torch.device("cuda", 0)
    gv, gf = make_icosphere(subdivisions=4, radius=50.0)
    cap = synthesize_capture(gv, gf, num_views=4, resy=96, resx=128,
                             ior=1.5, device=dev)
    v0, f0 = make_icosphere(subdivisions=3, radius=47.0)
    return dev, build_mesh_state(v0, f0, device=dev), cap.views


CARD_RAY = [[1], [3], [0], [2]] * 4
CARD_SILH = [[0, 1, 2, 3, 0, 1, 2, 3], [3, 2, 1, 0, 1, 1, 2, 2]] * 8


def _graphed(card, case):
    from drt_tpu_torch.optimize.loop import GraphedTrainStep
    dev, ms, views = card
    init, step = _step(case)
    return GraphedTrainStep(step, init(ms), 0.01, ms, views,
                            torch.tensor(CARD_RAY, device=dev),
                            torch.tensor(CARD_SILH, device=dev))


def _device_markers(fn):
    """(result of fn, the span markers of the device trace in order)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev_ev, _ = tracing.collect(prof)
    marks = [(PS.marker(n), s) for n, s, _ in dev_ev
             if PS.marker(n) is not None]
    return out, [m for m, _ in sorted(marks, key=lambda m: m[1])]


def _markers_until(fn, want, tries=3):
    """The device markers of a profiled call of fn, profiled again (a new
    call) while they differ from `want`, at most `tries` times: a CUDA
    profile now and then loses an operation."""
    for _ in range(tries):
        _, marks = _device_markers(fn)
        if marks == want:
            break
    return marks


def _names(log):
    """The device markers' sequence of a (name, edge) order: every end is
    the one end marker."""
    return [name if edge == "begin" else "end" for name, edge in log]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids="+".join)
def test_capture_disables_the_markers_and_a_profiled_replay_shows_them(
        card, case):
    want = _names(ORDER[case])
    run = _graphed(card, case)
    run()                                       # the eager warm-up
    run()                                       # the capture, a replay
    assert len(run.markers) == len(want) and not run._markers_on
    graph, capture_s = run._graph, run.setup["capture_s"]
    _, raw = _device_markers(run._graph.replay)   # no switch: disabled
    assert raw == []
    assert _markers_until(run, want) == want    # switched on
    assert run._markers_on
    run()                                       # and off again
    assert not run._markers_on
    assert _markers_until(run, want) == want
    assert run._graph is graph and run.setup["capture_s"] == capture_s
    run.close()


@pytest.mark.cuda
@pytest.mark.parametrize("case,adjoints", [(("uadam", "sobolev"), 1),
                                           (("uadam", "h1"), 0)],
                         ids=["uadam+sobolev", "uadam+h1"])
def test_adjoint_solves_are_counted_a_step(card, case, adjoints):
    """`cg_adjoint_launches` counts the adjoint solves of
    `sobolev_solve`'s backward: one a step under sobolev (two solves in
    all), none under h1 (its one solve takes no gradient), eager and
    replayed."""
    run = _graphed(card, case)
    before = kernels.counters.snapshot()
    for _ in range(5):                  # warm-up, capture, three replays
        run()
    torch.cuda.synchronize()
    got = kernels.counters.snapshot()
    run.close()
    assert got["cg_adjoint_launches"] - before["cg_adjoint_launches"] \
        == 5 * adjoints
    assert got["cg_launches"] - before["cg_launches"] == 5 * (1 + adjoints)


@pytest.mark.cuda
def test_eager_step_on_the_card_launches_the_markers_in_order(card):
    dev, ms, views = card
    init, step = _step(("sgd", "none"))
    step(init(ms), 0.01, ms, views, CARD_RAY[0], CARD_SILH[0])
    want = _names(ORDER[("sgd", "none")])
    assert _markers_until(
        lambda: step(init(ms), 0.01, ms, views, CARD_RAY[0], CARD_SILH[0]),
        want) == want


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids="+".join)
def test_replays_with_markers_on_and_off_give_the_same_bits(card, case):
    runs = [_graphed(card, case) for _ in range(2)]
    for it in range(6):
        losses = []
        for k, run in enumerate(runs):
            if k == 1 and it >= 2:              # replays with markers on
                (loss, _), _ = _device_markers(run)
            else:
                loss, _ = run()
            losses.append(float(loss))
        assert losses[0] == losses[1], it
        for key in ("params", "m", "v", "silh_max"):
            assert torch.equal(runs[0].state[key], runs[1].state[key]), key
    assert runs[1].markers and runs[1]._markers_on
    for run in runs:
        run.close()
