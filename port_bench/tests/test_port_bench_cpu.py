"""The yardstick against the port on the CPU at icosphere size: the
capture maker against `synthesize_capture`, the soft mask against
`process_mask`, the plain reference against the port's step, a whole
run of a tiny cell, sound and with faults planted in the timed path, and
cells whose configurations bring references of their own beside
step.py."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from faults import FAULTS
from port_bench import bench, capture, readings
from port_bench import traffic as traffic_gen
from port_bench.meshio import load_mesh
from port_bench.reference import step as ref

LOOSE = {"loss_gap": 0.1, "ray_gap": 0.1, "vh_gap": 0.1, "sm_gap": 0.1,
         "grad_gap": 0.1, "update_gap": 0.5, "update_rule_gap": 0.01}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """(root, cfg, mix, gt, init, views) of the tiny sgd cell."""
    tmp = tmp_path_factory.mktemp("cell")
    root = tiny.make_root(str(tmp), limits=LOOSE)
    _c, cfg, mix, _l, _m = bench.resolve("tiny", root)
    gt = load_mesh(root, cfg["ground_truth"])
    init = load_mesh(root, cfg["init_mesh"])
    views = capture.load(*gt, cfg, "cpu", str(tmp / "cache"))
    return root, cfg, mix, gt, init, views


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soft_mask_is_process_mask(seed):
    from drt_tpu_torch.data.masks import process_mask
    rng = np.random.default_rng(seed)
    m = rng.random((23, 31)) < [0.02, 0.3, 0.7][seed]
    m[5:12, 8:20] = True
    got = capture.soft_mask(torch.as_tensor(m)).numpy()
    want = process_mask(m.astype(np.uint8)).astype(np.float32)
    assert np.array_equal(got, want)


def test_capture_matches_synthesize_capture(cell):
    from drt_tpu_torch.data.synthetic import synthesize_capture
    _root, cfg, _mix, gt, _init, views = cell
    rig = cfg["rig"]
    cap = synthesize_capture(*gt, num_views=rig["num_views"],
                             resy=rig["resy"], resx=rig["resx"],
                             ior=cfg["ior"], ext_ior=cfg["ext_ior"],
                             backend="brute", num_view_used=rig["num_views"],
                             device="cpu")
    want = cap.views
    for k in ("R", "K", "R_inv", "K_inv", "origin", "ray_dir", "mask"):
        assert torch.equal(getattr(views, k), getattr(want, k)), k
    both = views.valid & want.valid
    assert int((views.valid ^ want.valid).sum()) <= 2      # ties aside
    assert int(both.sum()) > 500
    gap = (views.screen_pixel - want.screen_pixel)[both].abs().max()
    assert float(gap) < 1e-3


@pytest.mark.parametrize("opt,pre,lr", [("sgd", "none", 0.05),
                                        ("uadam", "h1", 0.01)])
def test_reference_step_is_the_port_step(cell, opt, pre, lr):
    """A step of the reference against the port's eager step with the
    brute oracle, in float32: the loss, its parts, the gradient and the
    update. (Later steps start from meshes that differ by rounding, on
    which a lane at a shared edge may take the other face: at this size
    one lane moves the loss by tenths of a percent.)"""
    from drt_tpu_torch.data.views import ViewBatch
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.mesh.state import build_mesh_state
    from drt_tpu_torch.optimize.loop import make_train_step
    from drt_tpu_torch.optimize.losses import LossWeights
    _root, cfg, mix, _gt, init, views = cell
    cfg = dict(cfg, optimizer=opt, precond=pre, lr=lr)
    rays, silhs = traffic_gen.view_rows(mix, 4, 2 ** 33 + 5, 1)
    mesh = build_mesh_state(*init, device="cpu")
    w = LossWeights(cfg["ray_w"], cfg["vh_w"], cfg["sm_w"], cfg["ior"],
                    cfg["ext_ior"])
    init_state, step, _ = make_train_step(
        get_intersect_fn("brute"), w, 24, 32, cfg["silhouette_budget"],
        optimizer=opt, precond=pre)
    state, loss, aux = step(init_state(mesh), lr, mesh, ViewBatch(*views),
                            rays[0], silhs[0])
    want = bench.reference_steps(cfg, ref, views, init, rays, silhs,
                                 "cpu")
    assert float(loss) == pytest.approx(want["losses"][0], rel=1e-5)
    for p in bench.PARTS:
        assert float(aux[p]) == pytest.approx(want["parts"][0][p], rel=1e-5)
    nv = mesh.num_vertices

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    assert rel(ref.first_grad(state["m"][:nv], opt), want["g1"]) < 1e-5
    assert rel(state["params"][:nv], want["delta"]) < 5e-5


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_run_is_correct_and_its_faults_are_not(cell, monkeypatch, fault):
    if fault:
        FAULTS[fault](monkeypatch)
    out = bench.run_cell("tiny", 2 ** 31 + 11, 0.2, False, 0.0, cell[0],
                         device="cpu", runner=tiny.EagerRunner)
    assert out["attempted"] >= 100 and out["failed"] == 0
    assert out["metrics"]["step_ms"]["value"] > 0
    assert out["correct"] is (fault is None), out["checks"]
    assert set(out["checks"]) == set(LOOSE)


def test_readings_give_each_kind(cell):
    out = readings.readings("tiny", [3], [3], [3], cell[0], "cpu",
                            tiny.EagerRunner, log=lambda *a, **k: None,
                            look=[3])
    assert set(out["program"][3]) >= set(LOOSE)
    assert set(out["control"]) == set(bench.CONTROLS)
    assert out["fault"]["half"][3]["loss_gap"] > LOOSE["loss_gap"]
    assert out["fault"]["frozen"][3]["update_rule_gap"] == pytest.approx(1.0)
    assert out["fault"]["frozen"][3]["update_dir_gap"] >= 1.0
    assert out["control"]["ray_bf16"][3]["loss_gap"] > 1e-3
    assert [s["step"] for s in out["look"][3]] == [1, 2, 3]
    assert 0.0 <= out["flip_share"] < 0.05


# Dropped-in references: step.py's step, noting each call beside the
# module; and step.py's with a pass that starts at SHIFT, as a
# reparameterized pass starts away from zero.
RECORDING = """from pathlib import Path

from port_bench.reference import step as base
from port_bench.reference.step import (first_grad, grad_from_momentum,
                                       init_state, precision, update)


def step(state, *a, **kw):
    with open(Path(__file__).with_name("steps.txt"), "a") as fh:
        fh.write("step\\n")
    return base.step(state, *a, **kw)
"""
SHIFT = (0.25, -0.125, 0.5)
SHIFTED = """import torch

from port_bench.reference import step as base
from port_bench.reference.step import (first_grad, grad_from_momentum,
                                       precision, step, update)


def init_state(mesh):
    state = base.init_state(mesh)
    return dict(state, params=state["params"] + torch.tensor(%r))
""" % (SHIFT,)


def drop_in(root, name, source):
    """Into the checkout at root, new files and entries only: a
    configuration '<name>-cfg' (the tiny one under another name), its
    reference reference/<name>-cfg.py, the cell <name> of that
    configuration with the tiny cell's limits. Returns the
    configuration."""
    pb = os.path.join(root, "port_bench")
    with open(os.path.join(pb, "reference", f"{name}-cfg.py"), "w") as fh:
        fh.write(source)
    cfg = bench.read_json(os.path.join(pb, "configs", "tiny-cfg.json"))
    cfg.update(name=f"{name}-cfg")
    with open(os.path.join(pb, "configs", f"{name}-cfg.json"), "w") as fh:
        json.dump(cfg, fh)
    shutil.copy(os.path.join(pb, "limits", "tiny.json"),
                os.path.join(pb, "limits", f"{name}.json"))
    man = bench.read_json(os.path.join(root, "BENCHMARK.json"))
    man["configs"].append(dict(man["configs"][0], name=cfg["name"],
                               file=f"port_bench/configs/{name}-cfg.json"))
    man["workloads"].append(dict(man["workloads"][0], name=name,
                                 config=cfg["name"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(man, fh)
    return cfg


def test_a_dropped_in_reference_is_found_without_an_edit(cell):
    root = cell[0]
    drop_in(root, "tiny-recorded", RECORDING)
    out = bench.run_cell("tiny-recorded", 2 ** 31 + 29, 0.2, False, 0.0,
                         root, device="cpu", runner=tiny.EagerRunner)
    assert out["correct"], out["checks"]
    with open(os.path.join(root, "port_bench", "reference",
                           "steps.txt")) as fh:
        assert fh.read().split() == ["step"] * 3


class ShiftedRunner(tiny.EagerRunner):
    """The program's pass started at SHIFT on the mesh's own vertices."""

    def __init__(self, step, state, lr, mesh, *a):
        super().__init__(step, state, lr, mesh, *a)
        self.state["params"][:mesh.num_vertices] += torch.tensor(SHIFT)


def test_the_change_is_taken_from_the_fresh_parameters(cell):
    """A pass whose fresh parameters are not zero, on both sides: the
    change is the parameters after the steps less the fresh ones, and the
    optimizer's walk starts from them (from zeros it reads 5.6)."""
    root, _cfg, mix, _gt, init, views = cell
    cfg = drop_in(root, "tiny-shifted", SHIFTED)
    ref = bench.reference_of(cfg, root)
    rays, silhs = traffic_gen.view_rows(mix, 4, 2 ** 31 + 7, 4)
    prog = bench.Program(cfg, views, init, rays, silhs, "cpu", ShiftedRunner)
    got = prog.first_steps(3, cfg["optimizer"], ref)
    want = bench.reference_steps(cfg, ref, views, init, rays[:3],
                                 silhs[:3], "cpu")
    found = bench.gaps(got, want, cfg, ref)
    assert found["update_rule_gap"] < 1e-6
    assert found["update_gap"] < 1e-3 and found["loss_gap"] < 1e-3
    for side in (got, want):
        assert torch.equal(side["fresh"]["params"][0], torch.tensor(SHIFT))
        assert torch.equal(side["delta"], side["states"][-1]["params"]
                           - side["fresh"]["params"])
    zero = {k: torch.zeros_like(v) for k, v in got["fresh"].items()}
    assert bench.rule_gap(got["states"], cfg, ref, zero) >= 1.0


def test_the_tiny_cells_gaps_are_as_before(cell):
    """Where the pass starts at zero parameters, as in every cell of
    reference/step.py, each number reads bit for bit what it read when
    the change was the reference's parameters after the steps and the
    optimizer's walk started from zeros."""
    root, cfg, mix, _gt, init, views = cell
    ref = bench.reference_of(cfg, root)
    rays, silhs = traffic_gen.view_rows(mix, 4, 2 ** 31 + 13, 4)
    prog = bench.Program(cfg, views, init, rays, silhs, "cpu",
                         tiny.EagerRunner)
    got = prog.first_steps(3, cfg["optimizer"], ref)
    want = bench.reference_steps(cfg, ref, views, init, rays[:3],
                                 silhs[:3], "cpu")
    zero = {k: torch.zeros_like(v) for k, v in got["fresh"].items()}
    before = bench.gaps(dict(got, fresh=zero),
                        dict(want, delta=want["states"][-1]["params"]), cfg,
                        ref)
    assert bench.gaps(got, want, cfg, ref) == before
    assert torch.equal(want["delta"], want["states"][-1]["params"])


@pytest.mark.parametrize("opt", ["sgd", "uadam"])
def test_rule_gap_sees_the_optimizer_and_not_the_gradient(opt):
    """update_rule_gap reads nought on a run whose updates follow the
    reference's rule whatever its gradients, and sees a learning rate,
    a sign and a lost bias correction."""
    cfg = {"optimizer": opt, "momentum": 0.95, "lr": 0.01}
    gen = torch.Generator().manual_seed(5)
    state = {"params": torch.zeros(50, 3), "m": torch.zeros(50, 3),
             "v": 0.0, "count": 0}

    def run(scale=1.0, sign=1.0, count=None):
        st, out = dict(state), []
        for _ in range(3):
            g = torch.randn(50, 3, generator=gen).clamp(-1, 1)
            new = ref.update(dict(st, count=count or st["count"]), g,
                             cfg["lr"] * scale, cfg)
            new["params"] = st["params"] + sign * (new["params"]
                                                   - st["params"])
            new["count"] = st["count"] + 1
            out.append({"params": new["params"], "m": new["m"]})
            st = new
        return out
    def gap(states):
        return bench.rule_gap(states, cfg, ref, state)
    assert gap(run()) < 1e-5
    assert gap(run(scale=1.1)) == pytest.approx(0.1, 1e-3)
    assert gap(run(sign=-1.0)) == pytest.approx(2.0, 1e-3)
    if opt == "uadam":
        assert gap(run(count=1)) > 0.1


def test_rows_gap_sees_signs_rows_and_scale_but_not_a_few_vertices():
    gen = torch.Generator().manual_seed(3)
    b = torch.randn(1000, 3, generator=gen)
    a = b.clone()
    a[:50] *= 50.0
    assert bench.rows_gap(a, b) == 0.0
    assert bench.rows_gap(a, b, own_scale=True) < 0.1
    assert bench.rows_gap(-b, b, q=0.5) == pytest.approx(2.0, rel=1e-2)
    assert bench.rows_gap(-b, b) > 2.0
    assert bench.rows_gap(b.roll(1, 0), b) > 1.0
    assert bench.rows_gap(2 * b, b, q=0.5) == pytest.approx(1.0, rel=1e-2)
    assert bench.rows_gap(2 * b, b, own_scale=True) < 1e-12
    assert bench.rows_gap(0 * b, b, own_scale=True, q=0.5) == pytest.approx(
        1.0, rel=1e-2)
