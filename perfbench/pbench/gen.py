"""The data generator: every mix under ``perfbench/traffic/`` is a file of
parameters that this module reads (the x range, the noise, the spread of
the planted coefficients).

Frozen copy, with changes, of the data the port's fit launcher draws
(``src/repro_torch/launch/serve.py``, ``serve_fits`` at commit 7ff5df5:
x ~ U(-2, 2), y a planted cubic with N(0, 1) coefficients plus N(0, 0.1²)
noise), which is also the README's ``api.fit`` example's data with noise
added.  The changes: the data is drawn on the device from the seed in a
few large calls, and each series has its own planted polynomial, so a
result handed to the wrong series reads wrong.
"""
from __future__ import annotations

import numpy as np

SEED_MOD = 2 ** 63


def torch_seed(seed: int, *stream: int) -> int:
    """A torch generator seed for ``seed`` (any whole number) and a stream
    id."""
    ss = np.random.SeedSequence([int(seed) % SEED_MOD, *stream])
    return int(ss.generate_state(1, np.uint64)[0] % SEED_MOD)


def planted_series(torch, gen, total: int, coefs, ids, traffic: dict,
                   device):
    """x ~ U(x_lo, x_hi) and y = the planted polynomial of each point's
    series (``coefs[ids]``, Horner in float32) + N(0, noise_sd²), drawn on
    ``device`` from the generator ``gen``."""
    lo, hi = traffic["x"]
    x = torch.rand(total, generator=gen, device=device,
                   dtype=torch.float32)
    x.mul_(hi - lo).add_(lo)
    deg = coefs.shape[-1] - 1
    y = coefs[:, deg][ids].clone()
    for k in range(deg - 1, -1, -1):
        y.mul_(x).add_(coefs[:, k][ids])
    y.add_(torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32), alpha=traffic["noise_sd"])
    return x, y


def planted_batch(torch, b: int, n: int, degree: int, traffic: dict,
                  seed: int, device):
    """A (b, n) float32 batch drawn on ``device`` from ``seed``: row i is
    n points of its own planted degree-``degree`` polynomial."""
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 0))
    coefs = torch.randn(b, degree + 1, generator=g, device=device,
                        dtype=torch.float32) * traffic["coef_sd"]
    ids = torch.arange(b, device=device).repeat_interleave(n)
    x, y = planted_series(torch, g, b * n, coefs, ids, traffic, device)
    del ids
    return x.view(b, n), y.view(b, n)
