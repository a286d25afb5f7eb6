"""On the card, at the cell's own size: a run of largesteps-step-90k is
correct, and against its committed limits the controls (TF32 on; the ray
path in bfloat16), the reference's faults (half the ray batch, the
parameters left unwritten, the adjoint solve left out) and the program's
(its state left unchanged, half the ray batch, the parameters left
unwritten, the adjoint solve left out) are not. One seed each; they skip
without a card."""

import os

import pytest

import faults
import sobolev_faults
from port_bench import bench, capture, readings
from port_bench import traffic as traffic_gen
from port_bench.meshio import load_mesh

pytestmark = pytest.mark.cuda
CELL = "largesteps-step-90k"
# The program's faults: those every training cell can have, and the
# adjoint solve left out. Half the trips (64 of the cap of 128, where the
# solves stop at 106-114) moves every compared number by less than the
# sound runs' own spread (PERF.md section 2), so no limit sees it here;
# tests/test_torch_largesteps.py shows it on the CPU at a cap that halving
# cuts short.
FAULTS = {**faults.FAULTS, "adjoint": sobolev_faults.adjoint_left_out}
REFERENCE_FAULTS = ("half", "frozen", "adjoint")


def test_a_run_is_correct_on_the_card(card):
    out = bench.run_cell(CELL, 2 ** 32 + 17, 2.0, False, 0.0, device=card)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 100 and out["failed"] == 0


@pytest.mark.parametrize("control", list(bench.CONTROLS))
def test_the_control_is_not_correct(card, control):
    limits = bench.resolve(CELL)[3]
    seed = 2 ** 32 + 19
    out = readings.readings(CELL, [], [seed], [], device=card,
                            log=lambda *a, **k: None)
    ok, checks = bench.judge(out["control"][control][seed], limits)
    assert not ok, checks


@pytest.fixture(scope="module")
def reference_faults():
    """The gaps of each of the reference's faults against the sound
    reference, on one seed."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    _cell, cfg, mix, _limits, _layer = bench.resolve(CELL)
    ref = bench.reference_of(cfg)
    views = capture.load(*load_mesh(bench.ROOT, cfg["ground_truth"]), cfg,
                         device, os.path.join(bench.BENCH_DIR, ".cache"))
    init = load_mesh(bench.ROOT, cfg["init_mesh"])
    n = mix["check_steps"]
    rays, silhs = traffic_gen.view_rows(mix, cfg["rig"]["num_views"],
                                        2 ** 32 + 21, n)
    want = bench.reference_steps(cfg, ref, views, init, rays, silhs, device)
    return {f: bench.gaps(bench.reference_steps(cfg, ref, views, init, rays,
                                                silhs, device, fault=f),
                          want, cfg, ref)
            for f in REFERENCE_FAULTS}


@pytest.mark.parametrize("fault", REFERENCE_FAULTS)
def test_a_reference_fault_is_not_correct(reference_faults, fault):
    ok, checks = bench.judge(reference_faults[fault],
                             bench.resolve(CELL)[3])
    assert not ok, checks


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_program_fault_is_not_correct(card, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = bench.run_cell(CELL, 2 ** 32 + 23, 1.0, False, 0.0, device=card)
    assert not out["correct"], out["checks"]
