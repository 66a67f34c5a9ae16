"""The ``mesh_fit`` system at CPU size, and the faults a run of it can
have.

A cell runs 4096 points a rank on its four ranks (gloo, on the CPU).
Each fault is planted in rank 0's process alone (the peers are fresh
processes) and still takes part in every collective, so no rank waits:

* ``answer_altered``: rank 0's coefficients moved where they are made;
* ``rank_dropped``: rank 0 keeps its own block's moments after the SUM
  all-reduce;
* ``domain_local``: rank 0 maps its block with the block's own min/max,
  not the global domain.
"""
from __future__ import annotations

import dataclasses

from pb_faults import Patches

SECONDS = 0.3
SHIFT = 0.05


def overrides(cell) -> dict:
    return {"config": {"points_per_rank": 4096}}


def answer_altered():
    from repro_torch.core import fit
    from_moments = fit.fit_from_moments

    def altered(*a, **k):
        poly = from_moments(*a, **k)
        return dataclasses.replace(poly, coeffs=poly.coeffs + SHIFT)
    p = Patches()
    p.set(fit, "fit_from_moments", altered)
    return p.restore


def rank_dropped():
    from repro_torch.core import distributed
    psum = distributed.psum_moments

    def local(m, *a, **k):
        psum(m, *a, **k)
        return m
    p = Patches()
    p.set(distributed, "psum_moments", local)
    return p.restore


def domain_local():
    from repro_torch.core import basis, distributed
    global_domain = distributed._global_domain

    def local(x, *a, **k):
        global_domain(x, *a, **k)
        return basis.Domain.from_data(x)
    p = Patches()
    p.set(distributed, "_global_domain", local)
    return p.restore


FAULTS = {"answer_altered": answer_altered, "rank_dropped": rank_dropped,
          "domain_local": domain_local}
