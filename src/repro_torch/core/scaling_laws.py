"""Power-law / scaling-law fits built on the paper's LSE core (port of
``repro.core.scaling_laws``).

loss(tokens) ≈ a · tokens^b + c  is fitted (for a fixed c-grid) by log-log
*linear* LSE — degree-1 matricized fitting on (log t, log (loss - c))."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fit as fit_lib
from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class PowerLaw:
    """y ≈ scale * x^exponent + offset."""

    scale: torch.Tensor
    exponent: torch.Tensor
    offset: torch.Tensor
    sse_log: torch.Tensor  # Σe² in log space (model-selection score)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x ** self.exponent + self.offset


def fit_power_law(x, y, *, offsets=None, device=None) -> PowerLaw:
    """Fit y = a x^b + c. Grid-search c over ``offsets`` (default: 0 plus a
    small grid below min(y)), solving each candidate with the matricized
    degree-1 LSE in log space, and keep the best by log-space Σe².
    ``device=None`` means CUDA."""
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    if offsets is None:
        offsets = torch.cat([
            torch.zeros((1,), dtype=y.dtype, device=dev),
            torch.min(y) * torch.linspace(0.0, 0.999, 32, dtype=y.dtype,
                                          device=dev)])
    else:
        offsets = as_tensor(offsets, dev, y.dtype)

    lx = torch.log(x)
    tiny = torch.finfo(y.dtype).tiny
    scales, exps, sses = [], [], []
    for c in offsets:
        ly = torch.log(torch.clamp_min(y - c, tiny))
        poly = fit_lib.polyfit(lx, ly, 1, normalize=True, device=dev)
        sses.append(torch.sum((poly(lx) - ly) ** 2))
        mono = poly.coeffs  # normalized-domain coeffs; recover raw a, b:
        # ly = m0 + m1 * ((lx - shift) * scale)  =>  b = m1*scale,
        # log a = m0 - m1*scale*shift
        exps.append(mono[1] * poly.domain_scale)
        scales.append(torch.exp(
            mono[0] - mono[1] * poly.domain_scale * poly.domain_shift))
    i = int(torch.argmin(torch.stack(sses)))
    return PowerLaw(scale=scales[i], exponent=exps[i], offset=offsets[i],
                    sse_log=sses[i])
