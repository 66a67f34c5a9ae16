"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card (a
CUDA kernel has no CPU mode).  The file imports neither jax nor the
reference package, so it runs on a machine that has only the port:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: max|Δ| <= 1e-5 · max|ref| per series, against the plain
version accumulated in float64 (float32 sums over ~5000 points)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import moments as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3, 7, 14, 20, 126])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("compensated", [False, True])
def test_cuda_moment_kernels_match_plain(cuda, degree, dtype, compensated):
    g = torch.Generator(device=cuda).manual_seed(degree)
    b, n = 11, 5003
    x = (torch.rand(b, n, generator=g, device=cuda) * 2 - 1).to(dtype)
    y = torch.randn(b, n, generator=g, device=cuda).to(dtype)
    w = torch.rand(b, n, generator=g, device=cuda) * (
        torch.rand(b, n, generator=g, device=cuda) > 0.3)
    for wc in (None, w):
        want = K.moments_block_plain(x, y, wc, degree, torch.float64)
        for fn in (K.moments_plain, K.moments_packed):
            got = fn(x, y, wc, degree=degree, compensated=compensated)
            torch.cuda.synchronize()
            err = (got.double() - want).abs().amax((1, 2))
            assert bool((err <= 1e-5 * want.abs().amax((1, 2))).all())
            again = fn(x, y, wc, degree=degree, compensated=compensated)
            assert torch.equal(got, again)          # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3, 9, 127])
def test_cuda_report_kernel_matches_plain(cuda, degree):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(5, 7001, generator=g, device=cuda) * 2 - 1
    y = torch.randn(5, 7001, generator=g, device=cuda)
    c = torch.randn(5, degree + 1, generator=g, device=cuda) / (degree + 1)
    got = K.fused_report(x, y, None, c)
    want = K.fused_report_plain(x, y, None, c, torch.float64)
    err = (got.double() - want).abs().amax(0)
    assert bool((err <= 1e-5 * want.abs().amax(0)).all())


@pytest.mark.cuda
def test_cuda_launch_counts_and_fit(cuda):
    from repro_torch import api, core
    K.reset_launch_counts()
    x = torch.rand(4, 40000, device=cuda) * 2 - 1
    y = 1 + x - x ** 3
    res = api.fit(x, y, api.FitSpec(degree=3))
    core.fit_report_streamed(res.poly, x, y)
    api.fit(x[0], y[0], api.FitSpec(degree=3))
    assert K.launch_counts() == {"moments_plain": 1, "moments_packed": 1,
                                 "fused_report": 1}
    np.testing.assert_allclose(res.coeffs.cpu().numpy(),
                               np.tile([1.0, 1.0, 0.0, -1.0], (4, 1)),
                               atol=1e-4)
