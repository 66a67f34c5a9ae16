"""Faults planted in the program underneath a run, to see ``correct``
come out false: each patches the port in this process and returns the
function that undoes it.

* ``state_unchanged``: a step returns its state unchanged (a stream's
  update, the moments of a fit come back empty);
* ``half_batch``: half of each chunk or block left out, the fit taken
  over the rest;
* ``answer_altered``: a fit's coefficients altered where they are made.
"""
from __future__ import annotations

import dataclasses

FAULTS = ("state_unchanged", "half_batch", "answer_altered")
SHIFT = 0.05


def apply(name: str):
    import torch
    from repro_torch import engine
    from repro_torch.core import fit, streaming
    undo = []

    def patch(mod, attr, new):
        undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    moments = engine.compute_moments
    update = streaming.update
    if name == "state_unchanged":
        patch(streaming, "update", lambda state, *a, **k: state)

        def empty(plan, x, y, weights=None):
            m = moments(plan, x, y, weights)
            return type(m)(*(torch.zeros_like(getattr(m, f.name))
                             for f in dataclasses.fields(m)))
        patch(engine, "compute_moments", empty)
    elif name == "half_batch":
        def half(a):
            return None if a is None else a[..., :a.shape[-1] // 2]

        def half_update(state, x, y, weights=None, **k):
            return update(state, half(x), half(y), weights=half(weights),
                          **k)

        def half_moments(plan, x, y, weights=None):
            return moments(plan, half(x).contiguous(), half(y).contiguous(),
                           None if weights is None
                           else half(weights).contiguous())
        patch(streaming, "update", half_update)
        patch(engine, "compute_moments", half_moments)
    elif name == "answer_altered":
        from_moments = fit.fit_from_moments

        def altered(*a, **k):
            p = from_moments(*a, **k)
            return dataclasses.replace(p, coeffs=p.coeffs + SHIFT)
        patch(fit, "fit_from_moments", altered)
    else:
        raise ValueError(f"unknown fault {name!r}")

    def restore():
        for mod, attr, old in reversed(undo):
            setattr(mod, attr, old)
    return restore
