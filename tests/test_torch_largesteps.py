"""Large Steps on the port: the uadam + sobolev step of `make_train_step`
against its plain reference, port_bench/reference/dog-pointgray-largesteps.py
(the benchmark configuration of that name), on the CPU at icosphere size
(port_bench/tests/tiny.py's cell: 4 views at 32x24).

The program's pass starts at u0 = (I + lam L) v0 and each step solves
v = (I + lam L)^-1 u in the forward pass and the gradient's adjoint solve in
backward; the reference does the same in plain torch on its own edges.
Compared: the fresh parameters, each step's loss and its parts, the first
gradient and the change after 3 steps, on seeded meshes and views; the
faults of the mechanism planted in the program (the adjoint solve left out,
the solves' trips halved) against the sound run's readings; a whole run of
a tiny cell of that configuration through the benchmark's harness; and the
reference refusing another lambda. No JAX here: the same pairing is held
to drt_tpu's make_train_step in tests/test_torch_optimizers.py."""

import json
import os

import numpy as np
import pytest
import torch

from port_bench import bench, capture
from port_bench import traffic as traffic_gen
from port_bench.meshio import load_mesh
from port_bench.reference.mesh import ref_mesh
from port_bench.tests import tiny
from port_bench.tests.sobolev_faults import FAULTS as PROGRAM_FAULTS

CONFIG = "dog-pointgray-largesteps"
# The icosphere's solves converge in few trips (u0 in 6): at a cap of 16
# the gradient's solve is still cut short by half of it, so the "trips"
# fault shows; 128 is the configuration's own cap.
CAPS = (16, 128)
SEEDS = (0, 1, 2)
# The numbers that decide `correct` in the benchmark's cells.
COMPARED = ("loss_gap", "vh_gap", "lanes_gap", "grad_gap", "grad_median_gap",
            "grad_rows_gap", "update_dir_gap", "update_rule_gap")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """(root, cfg, mix, init, views, ref): the tiny cell under uadam +
    sobolev at lr 0.01, and the configuration's reference module."""
    tmp = tmp_path_factory.mktemp("largesteps")
    root = tiny.make_root(str(tmp), optimizer="uadam", precond="sobolev",
                          lr=0.01)
    _c, cfg, mix, _l, _m = bench.resolve("tiny", root)
    gt = load_mesh(root, cfg["ground_truth"])
    init = load_mesh(root, cfg["init_mesh"])
    views = capture.load(*gt, cfg, "cpu", str(tmp / "cache"))
    ref = bench.reference_of({"name": CONFIG}, root)
    return root, cfg, mix, init, views, ref


def _mesh(init, seed):
    """The tiny cell's initial mesh moved by a seeded offset of about 1.6%
    of its mean edge (3.1) a coordinate."""
    rng = np.random.default_rng(seed)
    return init[0] + rng.normal(scale=0.05, size=init[0].shape), init[1]


def _both(cell, seed, cap):
    """The program's first 3 steps (eager, on the CPU) and the reference's
    on the seed's mesh and views, at `cap` trips a solve."""
    _root, cfg, mix, init, views, ref = cell
    cfg = dict(cfg, cg_iters=cap)
    mesh = _mesh(init, seed)
    rays, silhs = traffic_gen.view_rows(mix, 4, 2 ** 31 + 100 + seed, 4)
    prog = bench.Program(cfg, views, mesh, rays, silhs, "cpu",
                         tiny.EagerRunner)
    got = prog.first_steps(3, cfg["optimizer"], ref)
    want = bench.reference_steps(cfg, ref, views, mesh, rays[:3], silhs[:3],
                                 "cpu")
    return got, want, cfg


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_step_is_the_references(cell, seed, cap):
    """Step 1 starts both sides from u0 up to rounding, so its loss and
    parts agree to float32's sums over a few hundred lanes (2e-5) and the
    lanes counted exactly; steps 2-3 start from parameters that differ by
    rounding, on which one lane at a shared edge may take the other face
    and move the loss by tenths of a percent at this size (1e-2). The first
    gradient passes two float32 CG solves and the oracle's lanes (5e-3;
    6.6e-4 at worst over six seeds and both caps); the change after 3
    steps carries the later steps' lanes too (3e-2; 7.8e-3 at worst)."""
    got, want, _cfg = _both(cell, seed, cap)
    assert got["losses"][0] == pytest.approx(want["losses"][0], rel=2e-5)
    for p in bench.PARTS:
        assert got["parts"][0][p] == pytest.approx(want["parts"][0][p],
                                                   rel=2e-5, abs=1e-6), p
    assert got["parts"][0]["lanes"] == want["parts"][0]["lanes"]
    for a, b in zip(got["losses"][1:], want["losses"][1:]):
        assert a == pytest.approx(b, rel=1e-2)
    assert _rel(got["g1"], want["g1"]) < 5e-3
    assert _rel(got["delta"], want["delta"]) < 3e-2


def test_init_state_is_the_references(cell):
    """u0 = (I + 29 L) v0 on both sides: the program's neighbour table
    against the reference's edges, each in float32, so within a few of
    float32's steps at the largest |u0| (2.2e-4 of about 260 read)."""
    from drt_tpu_torch.mesh.state import build_mesh_state
    from drt_tpu_torch.optimize.loop import make_train_step
    _root, cfg, _mix, init, _views, ref = cell
    mesh = _mesh(init, 7)
    ms = build_mesh_state(*mesh, device="cpu")
    init_state, _step, _final = make_train_step(
        None, None, 24, 32, 512, optimizer="uadam", precond="sobolev",
        precond_lambda=ref.LAMBDA)
    got = init_state(ms)
    want = ref.init_state(ref_mesh(*mesh, "cpu"))
    nv = ms.num_vertices
    u0 = want["params"]
    scale = float(u0.abs().max())
    assert float((got["params"][:nv] - u0).abs().max()) < 4e-6 * scale
    assert float(got["params"][nv:].abs().max()) == 0.0
    assert not torch.equal(u0, ms.vertices[:nv])       # u0 is not v0
    assert float(got["m"].abs().max()) == float(got["v"]) == 0.0
    assert float(want["m"].abs().max()) == want["v"] == want["count"] == 0


@pytest.mark.parametrize("fault", list(PROGRAM_FAULTS))
def test_the_mechanisms_faults_move_a_compared_number(cell, monkeypatch,
                                                      fault):
    """Each fault of the mechanism, planted in the program, reads 10 times
    or more the sound run's reading, and above 0.01, on a number that
    decides `correct`; the same fault planted in the reference reads the
    program's faulted run within the sound run's gaps on that number."""
    seed, cap = SEEDS[0], CAPS[0]
    sound = bench.gaps(*_both(cell, seed, cap), cell[5])
    PROGRAM_FAULTS[fault](monkeypatch)
    got, want, cfg = _both(cell, seed, cap)
    faulted = bench.gaps(got, want, cfg, cell[5])
    moved = [k for k in COMPARED
             if faulted[k] >= max(10 * sound[k], 0.01)]
    assert moved, (fault, faulted, sound)
    _root, _cfg, mix, init, views, ref = cell
    rays, silhs = traffic_gen.view_rows(mix, 4, 2 ** 31 + 100 + seed, 4)
    planted = bench.reference_steps(cfg, ref, views, _mesh(init, seed),
                                    rays[:3], silhs[:3], "cpu", fault=fault)
    same = bench.gaps(got, planted, cfg, ref)
    assert min(same[k] for k in moved) < 10 * max(sound[k] for k in moved)


def test_the_reference_refuses_another_lambda(cell):
    _root, cfg, _mix, init, views, ref = cell
    mesh = ref_mesh(*init, "cpu")
    state = ref.init_state(mesh)
    for bad in (dict(cfg, precond_lambda=20.0),
                dict(cfg, precond="h1"), dict(cfg, optimizer="adam")):
        with pytest.raises(ValueError):
            ref.step(state, 0.01, mesh, views, 0, [0, 1], bad)
    with pytest.raises(ValueError, match="fault"):
        ref.step(state, 0.01, mesh, views, 0, [0, 1], cfg, fault="halve")


def test_a_tiny_cell_of_the_configuration_runs_correct(cell, monkeypatch):
    """A cell whose configuration is named dog-pointgray-largesteps finds
    its reference by that name (not reference/step.py, which raises on
    sobolev) and runs correct through the harness; with the adjoint solve
    left out it does not."""
    root = cell[0]
    pb = os.path.join(root, "port_bench")
    cfg = bench.read_json(os.path.join(pb, "configs", "tiny-cfg.json"))
    cfg.update(name=CONFIG, cg_iters=CAPS[0])
    with open(os.path.join(pb, "configs", f"{CONFIG}.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pb, "limits", "tiny-ls.json"), "w") as fh:
        json.dump({"loss_gap": 1e-2, "grad_gap": 5e-3,
                   "update_dir_gap": 0.1, "update_rule_gap": 0.01}, fh)
    man = bench.read_json(os.path.join(root, "BENCHMARK.json"))
    man["configs"].append(dict(man["configs"][0], name=CONFIG,
                               file=f"port_bench/configs/{CONFIG}.json"))
    man["workloads"].append(dict(man["workloads"][0], name="tiny-ls",
                                 config=CONFIG))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(man, fh)
    assert os.path.basename(bench.reference_of(cfg, root).__file__) \
        == f"{CONFIG}.py"
    out = bench.run_cell("tiny-ls", 2 ** 31 + 41, 0.2, False, 0.0, root,
                         device="cpu", runner=tiny.EagerRunner,
                         log=lambda *a, **k: None)
    assert out["correct"], out["checks"]
    PROGRAM_FAULTS["adjoint"](monkeypatch)
    out = bench.run_cell("tiny-ls", 2 ** 31 + 41, 0.2, False, 0.0, root,
                         device="cpu", runner=tiny.EagerRunner,
                         log=lambda *a, **k: None)
    assert not out["correct"], out["checks"]
