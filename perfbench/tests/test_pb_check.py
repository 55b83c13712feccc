"""The check decides `correct` by the plain reference: a sound run on the
CPU (the port's plain twins) passes, while the program's float32 path
(the control) and each planted fault fail, on both configurations cut
small. The card's run of the same (tests marked cuda) is at the cut size
too; the cells' own sizes are read by perfbench/control.py."""

import pytest
import torch

from perfbench import faults
from perfbench.tests import small

CELLS = sorted(small.CELLS)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = small.run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    res = r["checks"]["residual_max"]
    assert 0 < res["value"] < 1e-13 and res["limit"] == 1e-10
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"step_ms", "step_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_float32_fails(workload):
    r = small.run(workload, dtype="float32")
    assert not r["correct"]
    assert r["checks"]["residual_max"]["value"] > 1e-9


FAULTED = [(w, f) for w in CELLS for f in sorted(faults.FAULTS)
           if faults.applies(f, small.config(small.CELLS[w])["batch"])]


@pytest.mark.parametrize("workload,fault", FAULTED)
def test_fault_fails(workload, fault):
    r = small.run(workload, hook=faults.FAULTS[fault])
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_card_run(workload, card):
    r = small.run(workload, device=None)
    assert r["correct"]
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(card)
    assert small.run(workload, device=None, dtype="float32")["correct"] \
        is False
