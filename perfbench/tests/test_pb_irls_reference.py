"""The plain IRLS reference agrees with a float64 numpy IRLS of the same
definitions (``np.median``, ``np.linalg.lstsq`` on the √w-scaled
Vandermonde matrix), series by series, on small contaminated series."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from reference import irls

# both sides iterate to a fixed point of the same map in float64; they
# differ by the roundoff of two solves (normal equations against a QR
# least squares), amplified by the map's contraction: 1e-7 relative is
# far above that and far below any change of fixed point
RTOL = 1e-7


def _numpy_irls(x, y, deg, loss):
    c_tune = {"huber": 1.345, "tukey": 4.685}[loss]
    v = np.vander(x, deg + 1, increasing=True)
    w = np.ones_like(y)
    floor = np.finfo(np.float64).eps * (1.0 + np.median(np.abs(y)))
    c = np.linalg.lstsq(v, y, rcond=None)[0]
    for _ in range(200):
        r = y - v @ c
        u = r / max(1.4826 * np.median(np.abs(r)), floor)
        if loss == "tukey":
            w = np.where(np.abs(u) < c_tune, (1 - (u / c_tune) ** 2) ** 2, 0)
        else:
            w = np.where(np.abs(u) <= c_tune, 1.0,
                         c_tune / np.maximum(np.abs(u), c_tune))
        sw = np.sqrt(w)
        new = np.linalg.lstsq(v * sw[:, None], y * sw, rcond=None)[0]
        done = (np.abs(new - c).max() / max(np.abs(new).max(), 1.0)
                <= 1e-12)
        c = new
        if done:
            break
    return c


def _series(rng, b, n):
    x = rng.uniform(-2, 2, (b, n))
    coef = rng.normal(0, 1, (b, 4))
    y = sum(coef[:, k:k + 1] * x ** k for k in range(4))
    y = y + rng.normal(0, 0.05, (b, n))
    bad = rng.uniform(size=(b, n)) < 0.2
    y = np.where(bad, y + rng.choice([-50.0, 50.0], (b, n)), y)
    return x, y


@pytest.mark.parametrize("loss", ["tukey", "huber"])
@pytest.mark.parametrize("n", [501, 1000])
def test_reference_matches_numpy_irls(loss, n):
    rng = np.random.default_rng(n)
    x, y = _series(rng, 5, n)
    # blocks of two rows: the blocks' seams are crossed too
    got = irls.fit(torch.from_numpy(x), torch.from_numpy(y), 3, loss,
                   block=2 * n)
    assert bool(got.converged.all())
    for i in range(5):
        want = _numpy_irls(x[i], y[i], 3, loss)
        np.testing.assert_allclose(got.coeffs[i].numpy(), want,
                                   rtol=RTOL, atol=RTOL)


def test_median_of_an_even_count_is_the_mean_of_the_middle_two():
    a = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 1.0, 9.0, 3.0]],
                     dtype=torch.float64)
    assert irls.median(a).flatten().tolist() == [2.5, 4.0]
    assert irls.median(a[:, :3]).flatten().tolist() == [3.0, 5.0]


def test_excess_is_zero_at_the_reference_and_positive_off_it():
    rng = np.random.default_rng(3)
    x, y = _series(rng, 2, 800)
    ref = irls.fit(torch.from_numpy(x), torch.from_numpy(y), 3, "tukey")
    assert irls.excess(ref, ref.coeffs).abs().max().item() == 0.0
    off = ref.coeffs.clone()
    off[:, 0] += 0.01
    # a shift of the constant by 0.01 costs Σw·0.01² of weighted SSE
    want = ref.gram[:, 0, 0] * 1e-4 / ref.sse
    got = irls.excess(ref, off)
    assert torch.allclose(got, want, rtol=1e-9)


def test_control_is_one_precision_below():
    rng = np.random.default_rng(4)
    x, y = _series(rng, 3, 1024)
    xt, yt = (torch.from_numpy(a).float() for a in (x, y))
    ctl = irls.fit(xt, yt, 3, "tukey", control=True)
    assert ctl.coeffs.dtype == torch.float32
    assert ctl.gram is None and ctl.sse is None
