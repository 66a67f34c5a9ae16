"""Training monitors built on the paper's streaming matricized LSE core
(port of ``repro.train.monitors``).

LossCurveMonitor: O(1)-state polynomial fit of loss-vs-step. Because the
paper's moments are additive, each `observe` folds one point into the running
Gram/moment statistics; divergence detection reads the fitted slope, and
`eta_to(target)` extrapolates. An exponential-forgetting window tracks the
recent trend exactly (γ-weighted least squares).

StepTimeMonitor: per-host step-time series fitted with degree-1 LSE; hosts
whose fitted level exceeds the fleet median fit by `threshold`× are flagged
as stragglers (see repro_torch.runtime.straggler for the mitigation hooks).

Both keep their stream on ``device`` (``None`` means CUDA): every
observation is one ``streaming.update``, planned on that device, and every
reading solves the running state there and brings the answer to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import fit as fit_lib
from repro_torch.core import streaming


def _f32(a, device) -> torch.Tensor:
    """Host values rounded to float32 on the host, then moved to
    ``device`` (the reference's ``jnp.asarray(a, jnp.float32)``)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


@dataclasses.dataclass
class LossCurveMonitor:
    degree: int = 2
    decay: float = 0.995          # exponential forgetting per observation
    ridge: float = 1e-6
    device: Any = None

    def __post_init__(self):
        self._state = streaming.StreamState.create(
            self.degree, decay=self.decay, dtype=torch.float32,
            device=self.device)
        self._n = 0
        self._x_scale = 1000.0     # steps scaled to keep Gram conditioned

    def observe(self, step: int, loss: float) -> None:
        dev = self._state.device
        x = _f32([step / self._x_scale], dev)
        y = _f32([loss], dev)
        self._state = streaming.update(self._state, x, y)
        self._n += 1

    @property
    def ready(self) -> bool:
        return self._n >= self.degree + 2

    def fit(self) -> fit_lib.Polynomial:
        return streaming.current_fit(self._state, ridge=self.ridge)

    def slope_at(self, step: int) -> float:
        """d(loss)/d(step) of the fitted curve at `step`."""
        poly = self.fit()
        c = poly.coeffs.cpu().numpy().astype(np.float64)
        t = step / self._x_scale
        ks = np.arange(1, len(c))
        return float(np.sum(ks * c[1:] * t ** (ks - 1)) / self._x_scale)

    def predict(self, step: int) -> float:
        return float(self.fit()(_f32(step / self._x_scale,
                                     self._state.device)))

    def diverging(self, step: int, patience_slope: float = 0.0) -> bool:
        """True when the recent fitted trend slopes upward."""
        return self.ready and self.slope_at(step) > patience_slope

    def eta_to(self, target_loss: float, step: int,
               horizon: int = 10_000_000) -> int | None:
        """Steps until the fitted curve reaches target_loss (None if never
        within horizon). Coarse scan of the extrapolated curve (robust for
        any degree) + fine refinement inside the first crossing bucket."""
        if not self.ready:
            return None
        poly = self.fit()
        dev = self._state.device

        def first_hit(lo: int, hi: int, n: int) -> int | None:
            steps = np.linspace(lo, hi, n)
            vals = poly(_f32(steps / self._x_scale, dev)).cpu().numpy()
            hit = np.nonzero(vals <= target_loss)[0]
            return int(steps[hit[0]]) if hit.size else None

        coarse = first_hit(step, step + horizon, 4096)
        if coarse is None:
            return None
        bucket = max(1, horizon // 4096)
        fine = first_hit(max(step, coarse - bucket), coarse + 1,
                         min(4096, 2 * bucket + 2))
        return (fine if fine is not None else coarse) - step


@dataclasses.dataclass
class StepTimeMonitor:
    """Fleet-wide straggler detection from per-host step times.

    Keeps one streaming degree-1 fit per host (batched Moments: the paper's
    matricization makes the per-host fits one batched solve).  On the card
    each observation is an (n_hosts, 1) update, which the planner gives
    the packed moment kernel."""
    n_hosts: int
    decay: float = 0.98
    threshold: float = 1.25       # fitted level vs fleet median
    device: Any = None

    def __post_init__(self):
        self._state = streaming.StreamState.create(
            1, batch=(self.n_hosts,), decay=self.decay, dtype=torch.float32,
            device=self.device)
        self._n = 0

    def observe(self, step: int, times_s) -> None:
        dev = self._state.device
        x = torch.full((self.n_hosts, 1), step / 1000.0, dtype=torch.float32,
                       device=dev)
        y = _f32(times_s, dev)[:, None]
        self._state = streaming.update(self._state, x, y)
        self._n += 1

    def fitted_levels(self, step: int) -> np.ndarray:
        poly = streaming.current_fit(self._state, ridge=1e-6)
        t = torch.full((self.n_hosts,), step / 1000.0, dtype=torch.float32,
                       device=self._state.device)
        # evaluate per-host fits at the current step
        c = poly.coeffs            # (hosts, 2)
        return (c[:, 0] + c[:, 1] * t).cpu().numpy().astype(np.float64)

    def stragglers(self, step: int) -> list[int]:
        if self._n < 3:
            return []
        lv = self.fitted_levels(step)
        med = np.median(lv)
        return [int(i) for i in np.nonzero(lv > self.threshold * med)[0]]
