"""``correct`` fails where it should: the control (the reference one
precision below, in the program's place) reads past every cell's limit,
and a run with the timed path broken underneath comes out not correct,
once for each fault its system can have (``small/<system>.py``).  A
sound run at the same size comes out correct."""
from __future__ import annotations

import pytest
import torch

import pb_faults
import pb_small
from pbench import cells, devtrace, runner

CASES = [(c, f) for c in pb_small.CELLS for f in pb_small.faults(c)]


@pytest.mark.parametrize("cell", pb_small.CELLS)
def test_sound_run_is_correct(cell):
    r = pb_small.run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    restore = pb_faults.apply(cell, fault)
    try:
        r = pb_small.run(cell)
    finally:
        restore()
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", pb_small.CELLS)
def test_control_reads_past_the_limits(cell):
    c = cells.load_cell(cell)
    ctx = runner.Ctx(torch=torch, device=torch.device("cpu"), cell=c,
                     seed=7, seconds=1.0, trace=False,
                     spans=devtrace.Spans(),
                     overrides=pb_small.overrides(cell))
    readings = cells.system_driver(c).control(ctx)
    assert any(v > c.limits[k] for k, v in readings.items()), readings
