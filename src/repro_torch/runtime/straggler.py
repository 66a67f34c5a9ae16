"""Straggler mitigation driven by the paper's LSE fits (port of
``repro.runtime.straggler``).

StepTimeMonitor (repro_torch.train.monitors) fits each host's step-time series
with a streaming degree-1 matricized LSE; this module turns its verdicts
into actions: per-host slowdown diagnosis and data re-slicing plans that
shrink the slow host's shard (work-stealing) without a restart.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:   # an annotation only: a runtime import would close the
    # cycle train.monitors -> core -> core.distributed -> runtime -> here
    from repro_torch.train.monitors import StepTimeMonitor


@dataclasses.dataclass(frozen=True)
class ResliceAction:
    """New per-host example counts for one global batch."""
    shares: tuple[int, ...]

    @property
    def total(self) -> int:
        return sum(self.shares)


def plan_reslice(monitor: StepTimeMonitor, step: int, global_batch: int,
                 min_share: int = 1) -> ResliceAction:
    """Give each host work inversely proportional to its fitted step time
    (projected throughput), keeping the global batch fixed. Integerizes with
    largest-remainder; every host keeps >= min_share.

    Raises ``ValueError`` when ``global_batch < n_hosts * min_share`` —
    there is no assignment giving every host its floor, and the previous
    behavior (silently returning shares summing to MORE than the global
    batch) corrupted the very invariant a reslice exists to keep."""
    levels = monitor.fitted_levels(step)
    n_hosts = levels.shape[0]
    if global_batch < n_hosts * min_share:
        raise ValueError(
            f"global_batch={global_batch} cannot give each of {n_hosts} "
            f"hosts min_share={min_share} (needs >= {n_hosts * min_share}); "
            "shrink min_share or grow the batch")
    levels = np.maximum(levels, 1e-6)
    speed = 1.0 / levels
    raw = speed / speed.sum() * global_batch
    base = np.maximum(np.floor(raw).astype(int), min_share)
    # distribute the remainder to the largest fractional parts
    rem = global_batch - base.sum()
    if rem > 0:
        order = np.argsort(-(raw - np.floor(raw)))
        for i in order[:rem]:
            base[i] += 1
    elif rem < 0:
        # the min_share clamp can overshoot by more than one unit per
        # host, so shrinking may need several passes; the guard above
        # guarantees the loop terminates at exactly the global batch
        order = np.argsort(raw - np.floor(raw))
        while rem < 0:
            for i in order:
                if rem == 0:
                    break
                if base[i] > min_share:
                    base[i] -= 1
                    rem += 1
    out = ResliceAction(tuple(int(b) for b in base))
    assert out.total == global_batch
    return out
