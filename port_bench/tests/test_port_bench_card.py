"""On the card, at the cell's own size: a run is correct, and the
control and each fault that a training cell can have make `correct`
false against the committed limits. These are the checks the limits were
set from (PERF.md), one seed each; they skip without a card."""

import pytest

from faults import FAULTS
from port_bench import bench, readings

pytestmark = pytest.mark.cuda
CELLS = ("parity-step-45k", "adv-step-90k", "parity-step-20k")


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_is_correct_on_the_card(card, workload):
    out = bench.run_cell(workload, 2 ** 32 + 17, 2.0, False, 0.0,
                         device=card)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 100 and out["failed"] == 0


@pytest.mark.parametrize("control", list(bench.CONTROLS))
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(card, workload, control):
    limits = bench.resolve(workload)[3]
    seed = 2 ** 32 + 19
    out = readings.readings(workload, [], [seed], [], device=card,
                            log=lambda *a, **k: None)
    ok, checks = bench.judge(out["control"][control][seed], limits)
    assert not ok, checks


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_is_not_correct(card, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    out = bench.run_cell(workload, 2 ** 32 + 23, 1.0, False, 0.0,
                         device=card)
    assert not out["correct"], out["checks"]
