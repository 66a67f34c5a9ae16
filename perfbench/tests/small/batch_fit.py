"""The ``batch_fit`` system at CPU size, and the faults a run of it can
have.

A cell runs 16 series of 512 points; a stream cell keeps its eight
blocks, of 64 points.  Each fault patches the port in this process and
returns the function that undoes it:

* ``state_unchanged``: a step returns its state unchanged (a stream's
  update, the moments of a fit come back empty);
* ``half_batch``: half of each chunk or block left out, the fit taken
  over the rest;
* ``answer_altered``: a fit's coefficients altered where they are made.
"""
from __future__ import annotations

import dataclasses

from pb_faults import Patches

OVERRIDES = {"config": {"batch": 16, "points": 512}}
CHUNK = {"config": {"chunk_points": 64}}
SECONDS = 0.3
SHIFT = 0.05


def overrides(cell) -> dict:
    ov = {k: dict(v) for k, v in OVERRIDES.items()}
    if cell.config.get("chunk_points"):
        ov["config"].update(CHUNK["config"])
    return ov


def state_unchanged():
    import torch
    from repro_torch import engine
    from repro_torch.core import streaming
    moments = engine.compute_moments

    def empty(plan, x, y, weights=None):
        m = moments(plan, x, y, weights)
        return type(m)(*(torch.zeros_like(getattr(m, f.name))
                         for f in dataclasses.fields(m)))
    p = Patches()
    p.set(streaming, "update", lambda state, *a, **k: state)
    p.set(engine, "compute_moments", empty)
    return p.restore


def half_batch():
    from repro_torch import engine
    from repro_torch.core import streaming
    moments = engine.compute_moments
    update = streaming.update

    def half(a):
        return None if a is None else a[..., :a.shape[-1] // 2]

    def half_update(state, x, y, weights=None, **k):
        return update(state, half(x), half(y), weights=half(weights), **k)

    def half_moments(plan, x, y, weights=None):
        return moments(plan, half(x).contiguous(), half(y).contiguous(),
                       None if weights is None
                       else half(weights).contiguous())
    p = Patches()
    p.set(streaming, "update", half_update)
    p.set(engine, "compute_moments", half_moments)
    return p.restore


def answer_altered():
    from repro_torch.core import fit
    from_moments = fit.fit_from_moments

    def altered(*a, **k):
        poly = from_moments(*a, **k)
        return dataclasses.replace(poly, coeffs=poly.coeffs + SHIFT)
    p = Patches()
    p.set(fit, "fit_from_moments", altered)
    return p.restore


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
