"""The ``robust_fit`` system at CPU size, and the faults a run of it can
have.

A cell runs 16 series of 4096 points.  Each fault patches the port in
this process and returns the function that undoes it:

* ``coefficient_nudged``: the constant term of every answer moved by
  ``NUDGE``, where ``irls_fit`` returns it;
* ``weights_dropped``: the ψ weights all 1, so the sweeps re-solve plain
  least squares and that stands in the robust fit's place;
* ``answer_to_neighbour``: each series handed the answer of the series
  before it;
* ``half_batch``: every moment pass handed only the first half of each
  series' points, so each sweep solves the fit of that half.
"""
from __future__ import annotations

import dataclasses

from pb_faults import Patches

OVERRIDES = {"config": {"batch": 16, "points": 4096}}
SECONDS = 1.0
# a shift of the constant by NUDGE costs about (NUDGE / σ)² of the
# weighted SSE, σ = 0.05 the traffic's noise: 0.04 here, far past the
# limit
NUDGE = 0.01


def overrides(cell) -> dict:
    return {k: dict(v) for k, v in OVERRIDES.items()}


def _answers_changed(change):
    from repro_torch.core import robust
    real = robust.irls_fit

    def changed(*a, **k):
        rfit, w = real(*a, **k)
        poly = dataclasses.replace(rfit.poly,
                                   coeffs=change(rfit.poly.coeffs))
        return dataclasses.replace(rfit, poly=poly), w
    p = Patches()
    p.set(robust, "irls_fit", changed)
    return p.restore


def coefficient_nudged():
    def nudge(c):
        c = c.clone()
        c[..., 0] += NUDGE
        return c
    return _answers_changed(nudge)


def weights_dropped():
    import torch
    from repro_torch.core import robust
    p = Patches()
    p.set(robust, "robust_weights",
          lambda u, loss, c: torch.ones_like(u))
    return p.restore


def answer_to_neighbour():
    import torch
    return _answers_changed(lambda c: torch.roll(c, 1, dims=0))


def half_batch():
    from repro_torch import engine
    moments = engine.compute_moments

    def half(a):
        return None if a is None else a[..., :a.shape[-1] // 2].contiguous()

    def half_moments(plan, x, y, weights=None, **k):
        return moments(plan, half(x), half(y), half(weights), **k)
    p = Patches()
    p.set(engine, "compute_moments", half_moments)
    return p.restore


FAULTS = {"coefficient_nudged": coefficient_nudged,
          "weights_dropped": weights_dropped,
          "answer_to_neighbour": answer_to_neighbour,
          "half_batch": half_batch}
