"""The plain reference agrees with float64 numpy least squares."""
from __future__ import annotations

import numpy as np
import torch

from reference import lsq


def _lstsq(x, y, deg, shift=0.0, scale=1.0):
    t = (np.asarray(x, np.float64) - shift) * scale
    v = np.vander(t, deg + 1, increasing=True)
    return np.linalg.lstsq(v, np.asarray(y, np.float64), rcond=None)[0]


def _data(rng, n, deg=3):
    x = rng.uniform(-2, 2, n).astype(np.float32)
    c = rng.normal(0, 1, deg + 1)
    y = (np.polyval(c[::-1], x) + rng.normal(0, 0.1, n)).astype(np.float32)
    return x, y


def test_series_sums_match_lstsq():
    rng = np.random.default_rng(0)
    lens = [7, 64, 300, 1000]
    xs, ys = zip(*(_data(rng, n) for n in lens))
    off = np.concatenate([[0], np.cumsum(lens)])
    m = lsq.series_sums(torch.from_numpy(np.concatenate(xs)),
                        torch.from_numpy(np.concatenate(ys)), off, 3,
                        block=128)
    c = lsq.solve(m, 0.0).numpy()
    sse = lsq.sse(m, torch.from_numpy(c)).numpy()
    for i, (x, y) in enumerate(zip(xs, ys)):
        ref = _lstsq(x, y, 3)
        assert np.allclose(c[i], ref, rtol=1e-8, atol=1e-9)
        r = y.astype(np.float64) - np.polyval(ref[::-1], x.astype(np.float64))
        assert np.isclose(sse[i], (r * r).sum(), rtol=1e-7)
    assert np.array_equal(m.count.numpy(), lens)


def test_row_sums_match_lstsq():
    rng = np.random.default_rng(1)
    x, y = zip(*(_data(rng, 500) for _ in range(3)))
    x, y = np.stack(x), np.stack(y)
    m = lsq.row_sums(torch.from_numpy(x), torch.from_numpy(y), 3, block=700)
    c = lsq.solve(m, 0.0).numpy()
    for i in range(3):
        assert np.allclose(c[i], _lstsq(x[i], y[i], 3), rtol=1e-8, atol=1e-9)
    # a fit in t = (x - shift)·scale, re-expressed in the raw variable
    shift, scale = 0.25, 0.5
    cf = _lstsq(x[0], y[0], 3, shift, scale)
    assert np.allclose(lsq.rebase(cf, shift, scale, 0.0, 1.0), c[0],
                       rtol=1e-7, atol=1e-8)


def test_excess_is_zero_at_the_reference_and_positive_off_it():
    rng = np.random.default_rng(2)
    x, y = _data(rng, 2000)
    m = lsq.row_sums(torch.from_numpy(x[None]), torch.from_numpy(y[None]), 3)
    c = lsq.solve(m, 0.0)
    s = lsq.sse(m, c)
    assert float(lsq.excess(m, c, s, c)) == 0.0
    off = c.clone()
    off[0, 0] += 0.01
    # a shift of the constant by 0.01 costs n·0.01² of SSE
    want = 2000 * 1e-4 / float(s[0])
    assert abs(float(lsq.excess(m, c, s, off)) - want) < 1e-9 * want
