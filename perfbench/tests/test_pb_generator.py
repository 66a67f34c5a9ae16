"""The data generator: the same seed gives the same inputs, another seed
other values of the same shape, a seed past 32 bits works, and each
series carries its own planted polynomial; the batch driver runs only
the closed loop its traffic file names."""
from __future__ import annotations

import pytest
import torch

import pb_small
from pbench import cells, gen

TRAFFIC = cells.load_json(cells.BENCH / "traffic" / "packed.json")


def _batch(seed):
    return gen.planted_batch(torch, 6, 300, 3, TRAFFIC, seed, "cpu")


def test_same_seed_same_inputs_other_seed_other_values():
    x1, y1 = _batch(2**40 + 3)
    x2, y2 = _batch(2**40 + 3)
    x3, y3 = _batch(5)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert x3.shape == x1.shape and not torch.equal(x1, x3)
    lo, hi = TRAFFIC["x"]
    assert float(x1.min()) >= lo and float(x1.max()) <= hi


def test_each_series_has_its_own_polynomial():
    x, y = _batch(11)
    fits = [torch.linalg.lstsq(
        torch.vander(x[i].double(), 4, increasing=True),
        y[i].double()[:, None]).solution.ravel() for i in range(6)]
    gaps = [float((fits[i] - fits[i + 1]).abs().max()) for i in range(5)]
    assert min(gaps) > 10 * TRAFFIC["noise_sd"] / 300 ** 0.5


def test_batch_driver_refuses_an_open_loop():
    cell = pb_small.CELLS[0]
    with pytest.raises(ValueError, match="closed-loop"):
        pb_small.run(cell, traffic={"arrivals": {"process": "poisson",
                                                 "rate_per_s": 10.0}})
