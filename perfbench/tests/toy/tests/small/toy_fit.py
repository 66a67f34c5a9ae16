"""The toy system at CPU size, and its one fault: the all-reduce alters
the sums it exchanges on rank 0 (Σy moved by n·SHIFT, a line's intercept
by SHIFT)."""
from __future__ import annotations

from pb_faults import Patches

SECONDS = 0.3
SHIFT = 0.05


def overrides(cell) -> dict:
    return {"config": {"points": 1024}}


def answer_altered():
    import torch.distributed as dist
    all_reduce = dist.all_reduce

    def altered(tensor, *a, **k):
        work = all_reduce(tensor, *a, **k)
        tensor[2].add_(tensor[0] * SHIFT)
        return work
    p = Patches()
    p.set(dist, "all_reduce", altered)
    return p.restore


FAULTS = {"answer_altered": answer_altered}
