"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card (a
CUDA kernel has no CPU mode).  The file imports neither jax nor the
reference package, so it runs on a machine that has only the port:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: max|Δ| <= 1e-5 · max|ref| per series, against the plain
version accumulated in float64 (float32 sums over ~5000 points)."""
import itertools

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
                                 "moments_packed_ring": 0,
                                 "fused_report": 1, "solve_small": 2}
    # a launch handed no map maps by the identity: the bits of the same
    # launch handed an identity domain of its own
    ident = core.Domain.identity(x.dtype, cuda)
    for fn in (K.moments_plain, K.moments_packed):
        assert torch.equal(fn(x, y, degree=3),
                           fn(x, y, degree=3, shift=ident.shift,
                              scale=ident.scale))
    np.testing.assert_allclose(res.coeffs.cpu().numpy(),
                               np.tile([1.0, 1.0, 0.0, -1.0], (4, 1)),
                               atol=1e-4)


# ------------------------------------------------------------ the solve kernel
def _extended_grams(cuda, shape, k, dtype, seed):
    """(k, k) Grams and (k,) right-hand sides of 64 points a series, as
    views of (k+1, k+1) extended Grams (the moment kernels' output); x ~
    U(c - 1, c + 1) with the centre c cycling over 0, 0.5, 1.5, 3, so κ
    runs from 1 to far past the float32 cap as k grows."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    nb, n = int(np.prod(shape)), 64
    f64 = {"dtype": torch.float64, "device": cuda}
    c = torch.tensor([0.0, 0.5, 1.5, 3.0], **f64).repeat(nb // 4 + 1)[:nb]
    x = c[:, None] + torch.rand(nb, n, generator=g, **f64) * 2 - 1
    y = torch.randn(nb, n, generator=g, **f64)
    w = torch.stack([x ** j for j in range(k)] + [y], dim=-2)
    ext = w @ w.transpose(-1, -2)
    ext = ((ext + ext.transpose(-1, -2)) / 2).to(dtype)
    ext = ext.reshape(*shape, k + 1, k + 1)
    return ext[..., :k, :k], ext[..., :k, k]


def _far_from_cap(kappa, dtype):
    """Series whose κ estimate lies a decade or more from the cap."""
    from repro_torch.core import solve as S
    return (kappa.double().log10()
            - np.log10(S.cond_cap_for(dtype))).abs() >= 1


def _check_flags(a, x, used, pused, pcond, dtype):
    """The kernel's guard is the float64 one (its κ is computed in
    double): it agrees with κ64 > cap, or a non-finite x, wherever κ64 lies
    a decade from the cap.  The plain chain estimates κ in the Gram's
    dtype, which in float32 reads high κ low by a decade and more: its
    flags are compared where its own estimate lies a decade from the cap
    too.  On a non-finite Gram both flag every series.  Where the two
    parts, κ64 lies past the cap or within two decades below it: float32
    eigenvalues err by about k·eps·max|λ|, so the chain reads κ past the
    cap only where κ64 exceeds some 1e6."""
    from repro_torch.core import solve as S
    kappa = S.condition_estimate(a.double())
    cap = S.cond_cap_for(dtype)
    bad64 = ~torch.isfinite(x).all(-1) | (kappa > cap)
    nonfinite = ~torch.isfinite(a).all(-1).all(-1)
    far = _far_from_cap(kappa, dtype) | nonfinite
    assert torch.equal(used[far], bad64[far])
    both = far & (_far_from_cap(pcond, dtype) | nonfinite)
    assert torch.equal(used[both], pused[both])
    assert bool((kappa[used != pused] >= cap / 100).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (0,)])
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_solve_kernel_matches_plain(cuda, dtype, k, shape):
    """Where neither side falls back, the kernel's coefficients have the
    plain chain's bits; the flags agree a decade from the cap either side
    (``_check_flags``); κ within test_torch_solve.py's condition tolerance
    of the float64 estimate, where that estimate holds seven digits
    (κ <= 1e9)."""
    from repro_torch.core import solve as S
    a, b = _extended_grams(cuda, shape, k, dtype, seed=k)
    K.reset_launch_counts()
    x, cond, used = S.solve_with_fallback(a, b)
    px, pcond, pused = S.solve_with_fallback_plain(a, b)
    assert K.launch_counts()["solve_small"] == (0 if 0 in shape else 1)
    for got, want in ((x, px), (cond, pcond), (used, pused)):
        assert got.shape == want.shape and got.dtype == want.dtype
    _check_flags(a, x, used, pused, pcond, dtype)
    well = ~used & ~pused
    assert torch.equal(x[well], px[well])
    ref = S.condition_estimate(a.double())
    sure = ref <= 1e9
    rtol = 1e-3 if dtype == torch.float32 else 1e-6
    err = (cond[sure].double() - ref[sure]).abs()
    assert bool((err <= rtol * ref[sure]).all())


def _rescue_cases(cuda, k, dtype):
    """Beside a healthy Gram: κ far past either cap from a bad scaling (its
    equilibrated matrix well conditioned), rank 1, all zero, indefinite, a
    NaN entry, an inf below and one above the diagonal, a NaN in b."""
    g = torch.Generator(device=cuda).manual_seed(100 + k)
    f64 = {"dtype": torch.float64, "device": cuda}
    q = torch.linalg.qr(torch.randn(k, k, generator=g, **f64))[0]
    spd = q @ torch.diag(torch.linspace(1.0, 10.0, k, **f64)) @ q.T
    dsc = torch.logspace(-3, 3, k, **f64)
    v = 0.7 ** torch.arange(k, **f64)
    rank1 = 50.0 * torch.outer(v, v)
    indef = torch.diag(torch.tensor([1.0, -2.0] * 4, **f64)[:k])
    a = torch.stack([spd, dsc[:, None] * spd * dsc, rank1,
                     torch.zeros(k, k, **f64), indef] + [spd] * 4)
    a = (a + a.transpose(-1, -2)) / 2
    b = torch.randn(9, k, generator=g, **f64)
    b[2] = rank1 @ torch.ones(k, **f64)
    b[3] = 0.0
    a, b = a.to(dtype), b.to(dtype)
    a[5, 0, 0] = float("nan")
    a[6, k - 1, 0] = float("inf")
    a[7, 0, k - 1] = float("inf")
    b[8, 0] = float("nan")
    return a, b


def _kept_condition(a, dtype):
    """κ of the equilibrated Gram over the eigenvalues the rescue keeps
    (float64; 1 where it keeps none)."""
    ad = torch.nan_to_num(a.double(), posinf=0.0)
    d = torch.diagonal(ad, dim1=-2, dim2=-1)
    d = torch.where(d > 0, d.clamp_min(1e-300).rsqrt(), torch.ones_like(d))
    w = torch.linalg.eigvalsh(ad * d[..., :, None] * d[..., None, :]).abs()
    cut = torch.finfo(dtype).eps * a.shape[-1] * w.amax(-1, keepdim=True)
    low = torch.where(w > cut, w, torch.full_like(w, float("inf"))).amin(-1)
    return torch.where(torch.isfinite(low), w.amax(-1) / low,
                       torch.ones_like(low))


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_solve_kernel_rescue_matches_svd_solve(cuda, dtype, k):
    """Where the guard trips, the kernel's rescue against the plain
    svd_solve: NaN where it is NaN, else within 64·k·eps·κ of the kept
    spectrum (the two differ in the eigensolver and its precision)."""
    from repro_torch.core import solve as S
    a, b = _rescue_cases(cuda, k, dtype)
    x, cond, used = S.solve_with_fallback(a, b)
    px, pcond, pused = S.solve_with_fallback_plain(a, b)
    _check_flags(a, x, used, pused, pcond, dtype)
    # κ is +inf by definition on a non-finite or all-zero Gram (on a rank-1
    # one either side may round the smallest eigenvalue to 0)
    undefined = ~torch.isfinite(a).all(-1).all(-1) | (a == 0).all(-1).all(-1)
    assert torch.isinf(cond[undefined]).all()
    assert torch.isinf(pcond[undefined]).all()
    both = used & pused
    xs = S.svd_solve(a, b)
    assert torch.equal(torch.isnan(x[both]), torch.isnan(xs[both]))
    fin = both & torch.isfinite(xs).all(-1)
    tol = 64 * k * torch.finfo(dtype).eps * _kept_condition(a, dtype)[fin]
    dx = (x[fin].double() - xs[fin].double()).norm(dim=-1)
    assert bool((dx <= tol * xs[fin].double().norm(dim=-1)).all())
    if k > 1:      # the bad scaling, rank 1, zero and non-finite Grams
        assert used[[1, 2, 3, 5, 6, 7, 8]].all() and not used[0]


@pytest.mark.cuda
@pytest.mark.parametrize("fallback", [None, "gauss"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_solve_kernel_flag_only(cuda, dtype, fallback):
    """No rescue: x is Gauss-Jordan's everywhere, bit for bit with the
    plain chain (NaN where it is NaN); fallback_used all False without a
    fallback, the guard's verdict with fallback == method."""
    from repro_torch.core import solve as S
    for k in range(1, 9):
        a, b = _rescue_cases(cuda, k, dtype)
        x, cond, used = S.solve_with_fallback(a, b, fallback=fallback)
        px, pcond, pused = S.solve_with_fallback_plain(a, b,
                                                       fallback=fallback)
        assert torch.equal(torch.isnan(x), torch.isnan(px))
        assert torch.equal(x.nan_to_num(), px.nan_to_num())
        if fallback is None:
            assert not bool(used.any()) and not bool(pused.any())
        else:
            _check_flags(a, x, used, pused, pcond, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("method,fallback,dtype,k", [
    ("cholesky", "svd", torch.float64, 4), ("qr", "svd", torch.float32, 4),
    ("gauss", "qr", torch.float32, 4), ("gauss", "svd", torch.float32, 9),
])
def test_cuda_solve_other_calls_keep_the_plain_chain(cuda, method, fallback,
                                                     dtype, k):
    from repro_torch.core import solve as S
    a, b = _extended_grams(cuda, (6,), k, dtype, seed=3)
    K.reset_launch_counts()
    got = S.solve_with_fallback(a, b, method=method, fallback=fallback)
    want = S.solve_with_fallback_plain(a, b, method=method,
                                       fallback=fallback)
    assert K.launch_counts()["solve_small"] == 0
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.nan_to_num(), w_.nan_to_num())


@pytest.mark.cuda
def test_cuda_fit_solves_in_one_launch_with_no_linalg_and_no_sync(
        cuda, monkeypatch):
    """api.fit at the benchmark's (4096, 65536), degree 3: one solve_small
    launch a call, torch.linalg's eigvalsh and svd never called, the
    coefficients the plain chain's bits on the same moments, and the
    solve itself free of any synchronising call."""
    from repro_torch import api
    from repro_torch.core import solve as S
    g = torch.Generator(device=cuda).manual_seed(26)
    x = torch.rand(4096, 65536, generator=g, device=cuda) * 4 - 2
    c = torch.randn(4096, 4, 1, generator=g, device=cuda)
    y = (c[:, 0] + x * (c[:, 1] + x * (c[:, 2] + x * c[:, 3]))
         + 0.1 * torch.randn(x.shape, generator=g, device=cuda))
    seen = []
    kernel_path = S.solve_with_fallback

    def record(a, b, **kw):
        out = kernel_path(a, b, **kw)
        seen.append((a, b, kw, out))
        return out

    def refuse(*args, **kwargs):
        raise AssertionError("torch.linalg called on the kernel path")

    monkeypatch.setattr(S, "solve_with_fallback", record)
    monkeypatch.setattr(torch.linalg, "eigvalsh", refuse)
    monkeypatch.setattr(torch.linalg, "svd", refuse)
    K.reset_launch_counts()
    for call in range(2):
        res = api.fit(x, y, api.FitSpec(degree=3))
        assert K.launch_counts()["solve_small"] == call + 1
    monkeypatch.undo()
    a, b, kw, (cx, ccond, cused) = seen[-1]
    assert len(seen) == 2 and a.shape == (4096, 4, 4)
    assert not bool(cused.any())
    px, pcond, pused = S.solve_with_fallback_plain(a, b, **kw)
    assert torch.equal(cx, px) and torch.equal(cused, pused)
    assert torch.equal(res.poly.coeffs, cx)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        S.solve_with_fallback(a, b, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3, 7, 14, 20, 62])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("compensated", [False, True])
def test_cuda_ring_kernel_bit_equals_packed(cuda, degree, dtype,
                                            compensated):
    """The ring changes only the loads: same bits as moments_packed for
    every block and nbuf, weighted or not, on ragged lengths and on views
    that start at an odd element (a bfloat16 row off its 4-byte word)."""
    g = torch.Generator(device=cuda).manual_seed(degree + 7)
    b, n = 11, 5003
    x = (torch.rand(b, n + 1, generator=g, device=cuda) * 2 - 1).to(dtype)
    y = torch.randn(b, n + 1, generator=g, device=cuda).to(dtype)
    w = torch.rand(b, n, generator=g, device=cuda) * (
        torch.rand(b, n, generator=g, device=cuda) > 0.3)
    for xc, yc in ((x[:, :n].contiguous(), y[:, :n].contiguous()),
                   (x.flatten()[1:1 + b * n].view(b, n),
                    y.flatten()[1:1 + b * n].view(b, n))):
        for wc in (None, w):
            want = K.moments_packed(xc, yc, wc, degree=degree,
                                    compensated=compensated)
            for block_n, nbuf in ((32, 2), (128, 3), (256, 4), (512, 2)):
                got = K.moments_packed_ring(xc, yc, wc, degree=degree,
                                            block_n=block_n, nbuf=nbuf,
                                            compensated=compensated)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (block_n, nbuf)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("accum", [torch.float32, torch.float64])
@pytest.mark.parametrize("compensated", [False, True])
def test_cuda_mapped_launch_bit_equals_the_launch_on_mapped_x(
        cuda, dtype, accum, compensated):
    """A launch handed the domain map gives the bits of the same launch on
    ``Domain.apply(x)``: plain, packed and the ring at nbuf 2, at degrees
    on both register kernels and on the shared-memory kernel (20),
    weighted or not, for the identity and a normalized domain (scale !=
    1), on a ragged n; each launch counts once under its launcher."""
    from repro_torch.core import basis
    g = torch.Generator(device=cuda).manual_seed(29)
    b, n = 11, 5003
    x = (torch.rand(b, n, generator=g, device=cuda) * 4 - 1).to(dtype)
    y = torch.randn(b, n, generator=g, device=cuda).to(dtype)
    w = (torch.rand(b, n, generator=g, device=cuda) * (
        torch.rand(b, n, generator=g, device=cuda) > 0.3)).to(accum)
    doms = (basis.Domain.identity(dtype, cuda), basis.Domain.from_data(x))
    assert float(doms[1].scale) != 1.0
    launchers = (K.moments_plain, K.moments_packed,
                 lambda *a, **k: K.moments_packed_ring(*a, block_n=128,
                                                       nbuf=2, **k))
    launches = 0
    for dom in doms:
        xd = dom.apply(x)
        for degree in (3, 7, 20):
            for fn in launchers:
                for wc in (None, w):
                    kw = dict(degree=degree, accum_dtype=accum,
                              compensated=compensated)
                    K.reset_launch_counts()
                    got = fn(x, y, wc, shift=dom.shift, scale=dom.scale,
                             **kw)
                    want = fn(xd, y, wc, **kw)
                    assert sum(K.launch_counts().values()) == 2
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (degree, fn, wc is None)
                    launches += 1
    assert launches == 36


@pytest.mark.cuda
def test_cuda_fit_maps_x_in_the_moments_kernel(cuda, monkeypatch):
    """api.fit at the benchmark's (4096, 65536), degree 3: one moments
    launch a call, mapping x, and coefficients bit-equal to the two-step
    path (x mapped by ``Domain.apply`` first, then the identity's launch),
    whose peak holds one more x."""
    from repro_torch import api, engine
    from repro_torch.api import executors
    g = torch.Generator(device=cuda).manual_seed(29)
    x = torch.rand(4096, 65536, generator=g, device=cuda) * 4 - 2
    y = torch.randn(x.shape, generator=g, device=cuda)
    spec = api.FitSpec(degree=3)
    real = engine.compute_moments

    def two_step(plan, xin, yin, w=None, *, domain=None):
        return real(plan, xin if domain is None else domain.apply(xin), yin,
                    w)

    def call():
        api.fit(x, y, spec)                  # warm the allocator's pools
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        res = api.fit(x, y, spec)
        torch.cuda.synchronize()
        return (res.poly.coeffs, K.launch_counts(),
                torch.cuda.max_memory_allocated() - base)

    got, launches, grew = call()
    monkeypatch.setattr(executors.engine_lib, "compute_moments", two_step)
    want, launches_two, grew_two = call()
    assert launches == launches_two == {
        "moments_plain": 0, "moments_packed": 1, "moments_packed_ring": 0,
        "fused_report": 0, "solve_small": 1}
    assert torch.equal(got, want)
    assert abs(grew_two - grew - x.numel() * x.element_size()) <= 2 << 20, \
        (grew, grew_two)


@pytest.mark.cuda
def test_cuda_nccl_mesh_fit_maps_x_in_the_moments_kernel(cuda, tmp_path,
                                                         monkeypatch):
    """A normalized fit on a 1-rank NCCL mesh: one moments launch, mapping
    the block, and the coefficients and domain bit-equal to the two-step
    path (the block mapped by ``Domain.apply`` before ``local_moments``)."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.core import distributed
    from repro_torch.launch import mesh as mesh_lib
    torch.cuda.set_device(cuda.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        mesh = mesh_lib.make_host_mesh(data=1)
        g = torch.Generator(device=cuda).manual_seed(31)
        x = torch.rand(1 << 24, generator=g, device=cuda) * 3 + 1.5
        y = 0.5 - x + 0.75 * x ** 3 + 0.1 * torch.randn(
            x.shape, generator=g, device=cuda)
        spec = api.FitSpec(degree=3,
                           numerics=api.NumericsPolicy(normalize=True))
        K.reset_launch_counts()
        got = spec.distributed(mesh)(x, y)
        assert K.launch_counts()["moments_plain"] == 1
        assert float(got.poly.domain_scale) != 1.0
        real = distributed.local_moments

        def two_step(xin, yin, degree, domain=None, **kw):
            return real(xin if domain is None else domain.apply(xin), yin,
                        degree, **kw)

        monkeypatch.setattr(distributed, "local_moments", two_step)
        K.reset_launch_counts()
        want = spec.distributed(mesh)(x, y)
        assert K.launch_counts()["moments_plain"] == 1
        for f in ("coeffs", "domain_shift", "domain_scale"):
            assert torch.equal(getattr(got.poly, f), getattr(want.poly, f)), f
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_ring_smem_path_with_static_and_dynamic_past_48k(cuda):
    """Degree 20: a 37 KB ring beside the 16 KB static tile needs the
    opt-in for more than 48 KB in all, though the ring alone is below."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand(5, 9000, generator=g, device=cuda) * 2 - 1
    y = torch.randn(5, 9000, generator=g, device=cuda)
    w = torch.rand(5, 9000, generator=g, device=cuda)
    want = K.moments_packed(x, y, w, degree=20)
    got = K.moments_packed_ring(x, y, w, degree=20, block_n=1024, nbuf=3)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3, 7, 14, 15, 20, 62])
def test_cuda_budget_model_matches_the_launcher(cuda, degree):
    """tune.ring_smem_bytes is the planning copy of the launcher's
    ring_cta_bytes: same bytes for every dtype pair, block, nbuf and
    weighting; and the card's opt-in limit is the planning budget."""
    from repro_torch.kernels import build, tune
    lib = build.library()
    for (din, dacc), bn, nbuf, wt in itertools.product(
            ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.float64, torch.float64), (torch.float32, torch.float64)),
            tune.CANDIDATE_BLOCKS, (2, 3, 4), (False, True)):
        want = lib.repro_ring_smem_bytes(K._IN_CODES[din], K._ACC_CODES[dacc],
                                         degree, bn, nbuf, int(wt))
        got = tune.ring_smem_bytes(degree, bn, nbuf=nbuf,
                                   itemsize=din.itemsize, weighted=wt,
                                   accum_itemsize=dacc.itemsize)
        assert got == want, (din, dacc, bn, nbuf, wt)
    assert tune.smem_budget(cuda) == tune.SMEM_BUDGET


@pytest.mark.cuda
def test_cuda_ring_refuses_a_ring_beyond_shared_memory(cuda):
    x = torch.rand(4, 70000, device=cuda)
    with pytest.raises(RuntimeError, match="moments_packed_ring launch"):
        K.moments_packed_ring(x, x, degree=3, block_n=4096, nbuf=4)


@pytest.mark.cuda
def test_cuda_ring_through_ops_and_tuner(cuda):
    from repro_torch.kernels import ops, tune
    tune.clear_cache()
    x = torch.rand(3, 4, 20000, device=cuda) * 2 - 1
    y = 1 + x - x ** 3
    bn = tune.autotune_block_n(3, 4096, device=cuda)
    assert bn in tune.feasible_blocks(3)
    assert tune.autotune_block_n(3, device=cuda) == bn   # cached
    K.reset_launch_counts()
    m0 = ops.moments(x, y, 3, packing="packed")
    m2 = ops.moments(x, y, 3, packing="packed", nbuf=2, block_n=bn)
    assert K.launch_counts()["moments_packed_ring"] == 1
    for f in ("gram", "vty", "yty", "count", "weight_sum"):
        assert torch.equal(getattr(m0, f), getattr(m2, f)), f
    assert m2.gram.shape == (3, 4, 4, 4)


@pytest.mark.cuda
def test_cuda_stream_snapshot_restore_is_bit_equal(cuda):
    from repro_torch import api
    from repro_torch.core import streaming
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand(64, 8 * 4096, generator=g, device=cuda) * 4 - 2
    y = 0.5 - x + 0.75 * x ** 3 + 0.1 * torch.randn(
        x.shape, generator=g, device=cuda)
    spec = api.FitSpec(degree=api.DegreeSearch(max_degree=5, folds=3),
                       decay=0.9999, domain=(0.0, 0.5))
    st = api.stream_state(spec, (64,))
    assert streaming.update_plan(st, (64, 4096), x.dtype).path \
        == "kernel_packed"
    K.reset_launch_counts()
    snap = None
    for i in range(8):
        st = streaming.update(st, x[:, i * 4096:(i + 1) * 4096],
                              y[:, i * 4096:(i + 1) * 4096])
        if i == 3:
            snap = st.snapshot()
    assert K.launch_counts()["moments_packed"] == 8
    rs = streaming.StreamState.restore(snap, spec=spec)
    for i in range(4, 8):
        rs = streaming.update(rs, x[:, i * 4096:(i + 1) * 4096],
                              y[:, i * 4096:(i + 1) * 4096])
    for a, b in ((rs.moments, st.moments), (rs.fold_moments,
                                            st.fold_moments)):
        for f in ("gram", "vty", "yty", "count", "weight_sum"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(api.stream_result(rs).best_degree,
                          api.stream_result(st).best_degree)


@pytest.mark.cuda
def test_cuda_unit_decay_stream_takes_the_unweighted_kernel_and_never_syncs(
        cuda):
    """The benchmark stream's shape: 4096 series fed the eight 8192-point
    column blocks of a (4096, 65536) batch at degree 3.  At γ = 1
    ``update`` hands the packed kernel no weights, and every running field
    has the bits of the same stream through the weighted launch (explicit
    ones, and a state without ``host_decay``, which takes the ladder).  An
    update at γ = 1 and one at γ = 0.99 run with the sync debug mode at
    "error": neither drains the queue."""
    import dataclasses

    from repro_torch import api, engine
    from repro_torch.core import streaming
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.rand(4096, 65536, generator=g, device=cuda) * 4 - 2
    y = 0.5 - x + 0.75 * x ** 3 + 0.1 * torch.randn(
        x.shape, generator=g, device=cuda)
    blocks = [(x[:, lo:lo + 8192], y[:, lo:lo + 8192])
              for lo in range(0, 65536, 8192)]

    def run(state, ones=False):
        engine.reset_moment_counter()
        K.reset_launch_counts()
        for xb, yb in blocks:
            state = streaming.update(
                state, xb, yb, weights=torch.ones_like(xb) if ones else None)
        return (state, engine.moment_counter()["weighted"],
                K.launch_counts()["moments_packed"])

    start = api.FitSpec(degree=3).streaming((4096,))
    got, weighted, launches = run(start)
    assert (weighted, launches) == (0, 8)
    for st, weighted, launches in (
            run(start, ones=True),
            run(dataclasses.replace(start, host_decay=None))):
        assert (weighted, launches) == (8, 8)
        for f in ("gram", "vty", "yty", "count", "weight_sum"):
            assert torch.equal(getattr(got.moments, f),
                               getattr(st.moments, f)), f
    for decay in (1.0, 0.99):
        st = streaming.update(api.FitSpec(degree=3, decay=decay)
                              .streaming((4096,)), *blocks[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            streaming.update(st, *blocks[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_cuda_stream_plans_by_shape(cuda):
    """A batch of series takes the packed kernel, one long series the
    plain kernel, one short series the reference path: on CUDA tensors,
    with no device argument."""
    from repro_torch import api
    from repro_torch.core import streaming
    x = torch.rand(1 << 16, device=cuda) * 2 - 1
    y = 1 + x - x ** 3
    for shape, path, kernel in (((4, 1 << 14), "kernel_packed",
                                 "moments_packed"),
                                ((1 << 16,), "kernel_plain", "moments_plain"),
                                ((1000,), "reference", None)):
        st = api.stream_state(api.FitSpec(degree=3), shape[:-1])
        assert streaming.update_plan(st, shape, x.dtype).path == path
        K.reset_launch_counts()
        st = streaming.update(st, x[:shape[-1]].expand(shape),
                              y[:shape[-1]].expand(shape))
        counts = K.launch_counts()
        assert sum(counts.values()) == (kernel is not None)
        if kernel:
            assert counts[kernel] == 1
        res = api.stream_result(st)
        np.testing.assert_allclose(res.coeffs.reshape(-1, 4)[0].cpu().numpy(),
                                   [1.0, 1.0, 0.0, -1.0], atol=1e-3)


@pytest.mark.cuda
def test_cuda_fit_server_ingest_solve_bit_equals_solve(cuda):
    """Every bucket ingest on the card is one packed-kernel launch (plus
    stream_sweeps − 1 per robust step), and the fused ingest+solve answers
    the default spec with the bits of the standalone solve."""
    from repro_torch import api, engine
    from repro_torch.core import streaming
    from repro_torch.serve import FitServeConfig, FitServeEngine
    eng = FitServeEngine(FitServeConfig(degree=3, n_slots=8,
                                        buckets=(256, 4096)))
    for b in eng.buckets:
        assert streaming.update_plan(b.state, (8, b.width),
                                     torch.float32).path == "kernel_packed"
    warm = eng.warmup()
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(40):
        n = int(rng.integers(8, 9000))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (1 + x - x ** 3 + 0.01 * rng.normal(size=n)).astype(np.float32)
        spec = api.FitSpec(degree=3, method="irls") if i % 5 == 4 else None
        reqs.append(eng.submit(x, y, spec=spec))
    engine.reset_moment_counter()
    K.reset_launch_counts()
    eng.run()
    assert all(r.done for r in reqs)
    assert K.launch_counts()["moments_packed"] \
        == engine.moment_counter()["calls"] > 0
    assert eng.compiled_executables() == warm + 1     # the IRLS spec
    for r in reqs:
        if r.spec.method == "lse":
            np.testing.assert_allclose(r.coeffs, [1, 1, 0, -1], atol=2e-2)
    # the last state of the widest bucket, solved standalone
    b = eng.buckets[-1]
    fused = eng.buckets[-1].ingest_solve.fn
    st = b.state
    args = (torch.zeros(8, b.width, device=cuda),) * 3 + (
        torch.ones(8, device=cuda), np.zeros(8, np.float32),
        torch.zeros(8, dtype=torch.int32, device=cuda),
        torch.ones(8, device=cuda))
    st2, out = fused(st, *args)
    alone = eng._solve(st2, eng.fixed_spec)
    for a, c in zip(out, alone):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [1, 3, 20])
def test_cuda_packed_kernel_at_one_point_per_series(cuda, degree):
    """The fleet's step-time monitor updates (n_workers, 1) batches, which
    the planner gives the packed kernel: one point per series."""
    from repro_torch.core import streaming
    g = torch.Generator(device=cuda).manual_seed(degree)
    x = torch.rand(4, 1, generator=g, device=cuda) * 4 - 2
    y = torch.randn(4, 1, generator=g, device=cuda)
    w = torch.tensor([[1.0], [0.0], [0.5], [2.0]], device=cuda)
    for wc in (None, w):
        want = K.moments_block_plain(x, y, wc, degree, torch.float64)
        for fn in (K.moments_plain, K.moments_packed):
            got = fn(x, y, wc, degree=degree)
            err = (got.double() - want).abs().amax((1, 2))
            assert bool((err <= 1e-5 * want.abs().amax((1, 2))).all())
    st = streaming.StreamState.create(1, (4,), decay=0.98)
    assert streaming.update_plan(st, (4, 1), torch.float32).path \
        == "kernel_packed"


def _fleet_traffic(k, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(lo, hi))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (0.5 - x + 0.25 * x ** 2 + 0.75 * x ** 3
             + 0.1 * rng.normal(size=n)).astype(np.float32)
        out.append((x, y))
    return out


@pytest.mark.cuda
def test_cuda_fleet_ingest_plans_the_plain_kernel(cuda):
    """At chunk_width 2^16 every fleet ingest is one weighted moments_plain
    launch; results leave the worker as host numpy."""
    from repro_torch.core import streaming
    from repro_torch.serve import fit_engine as fe
    from repro_torch.serve.fleet import FleetWorker, Ingest, Solve
    specs = fe.derive_pool_specs(fe.FitServeConfig(degree=3))
    wk = FleetWorker(0, specs, torch.float32, fe.make_spec_solve(3),
                     fe.make_spec_sweep(3))
    st = streaming.StreamState.create(3, spec=specs.fixed)
    assert streaming.update_plan(st, (1 << 16,), torch.float32).path \
        == "kernel_plain"
    (x, y), = _fleet_traffic(1, 70000, 70001)
    w = np.zeros(1 << 17, np.float32)
    w[:len(x)] = 1.0
    xp = np.zeros_like(w)
    yp = np.zeros_like(w)
    xp[:len(x)], yp[:len(y)] = x, y
    K.reset_launch_counts()
    for seq in (1, 2):
        sl = slice((seq - 1) << 16, seq << 16)
        wk.process(Ingest(1, seq, xp[sl], yp[sl], w[sl], specs.fixed), seq)
    assert K.launch_counts()["moments_plain"] == 2
    [res] = wk.process(Solve(1, specs.fixed), 3)
    assert all(isinstance(a, np.ndarray) for a in res.fixed)
    assert float(res.fixed[3]) == len(x)
    np.testing.assert_allclose(res.fixed[0], [0.5, -1, 0.25, 0.75],
                               atol=2e-2)


@pytest.mark.cuda
def test_cuda_fleet_chaos_parity(cuda):
    """Under a seeded schedule of every fault kind the fleet on the card
    returns coefficients bit-equal to its fault-free run, and the parallel
    pump equals the serial one."""
    from repro_torch.runtime import FAULT_KINDS, ChaosSchedule
    from repro_torch.serve import FitFleet, FitServeConfig, FleetConfig
    traffic = _fleet_traffic(24, 1 << 15, 1 << 18)

    def run(chaos=None, parallel=False):
        fleet = FitFleet(FleetConfig(
            fit=FitServeConfig(degree=3), n_workers=4, chunk_width=1 << 16,
            chaos=chaos, straggler_threshold=2.0, parallel_pump=parallel))
        reqs = [fleet.submit(x, y) for x, y in traffic]
        reqs.append(fleet.submit(*traffic[0], degree="auto"))
        h = fleet.submit_async_lspia(*traffic[1], n_shards=4)
        K.reset_launch_counts()
        fleet.run(max_ticks=20_000)
        fleet.close()
        return fleet, reqs, h, K.launch_counts()

    base, breqs, bh, blaunch = run()
    chaos = ChaosSchedule.parse("crash=1,stall=1,poison=1,drop=1,delay=1",
                                0, 4, horizon=16)
    fleet, reqs, h, launches = run(chaos)
    assert {e.kind for w in fleet.workers for e in w.faults_applied} \
        == set(FAULT_KINDS)
    assert fleet.stats["failed"] == 0 and fleet.stats["worker_deaths"] == 1
    assert blaunch["moments_plain"] > 0 and launches["moments_plain"] > 0
    for b, c in zip(breqs, reqs):
        assert c.done and c.failed is None and c.count == b.count
        np.testing.assert_array_equal(c.coeffs, b.coeffs)
    np.testing.assert_array_equal(h.coeffs, bh.coeffs)
    _, preqs, ph, plaunch = run(parallel=True)
    assert plaunch == blaunch
    for b, c in zip(breqs, preqs):
        np.testing.assert_array_equal(c.coeffs, b.coeffs)
    np.testing.assert_array_equal(ph.coeffs, bh.coeffs)


@pytest.mark.cuda
def test_cuda_launch_serve_fleet_assert_parity(cuda, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--workload", "fleet", "--assert-parity"]) == 0
    assert "parity OK" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_one_rank_nccl_mesh_fit_matches_eager(cuda, tmp_path):
    """A 1-rank NCCL mesh on the card: the shard's moment pass launches
    moments_plain, the fold stack of a search the kernel plan_fit picks,
    and the results match eager api.fit (the κ-scaled bound of
    tests/test_api.py; the same degree)."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch import api, engine
    from repro_torch.launch import mesh as mesh_lib
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        mesh = mesh_lib.make_host_mesh(data=1)
        g = torch.Generator(device=cuda).manual_seed(5)
        x = torch.rand(1 << 20, generator=g, device=cuda) * 4 - 2
        y = 0.5 - x + 0.75 * x ** 3 + 0.1 * torch.randn(
            x.shape, generator=g, device=cuda)
        for spec, kernel in (
                (api.FitSpec(degree=3), "moments_plain"),
                (api.FitSpec(degree=api.DegreeSearch(max_degree=6,
                                                     folds=5)),
                 "moments_packed")):
            K.reset_launch_counts()
            engine.reset_collective_counter()
            got = spec.distributed(mesh)(x, y)
            assert K.launch_counts()[kernel] == 1
            assert engine.collective_counter()["calls"] >= 1
            want = api.fit(x, y, spec)
            assert got.best_degree == want.best_degree
            kappa = float(want.poly.diagnostics.condition.max())
            c = want.coeffs.cpu().numpy()
            tol = 200 * kappa * np.finfo(np.float32).eps * max(
                1.0, float(np.abs(c).max()))
            # a mesh search keeps the zero-padded (max_degree+1) layout
            np.testing.assert_allclose(got.coeffs.cpu().numpy()[:c.size],
                                       c, rtol=0, atol=tol)
    finally:
        dist.destroy_process_group()


def _perfbench_lsq():
    """The benchmark's plain float64 reference (``perfbench/reference/
    lsq.py``: plain torch, nothing of the port)."""
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "perfbench" / "reference"
            / "lsq.py")
    spec = importlib.util.spec_from_file_location("perfbench_lsq", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path.parents[1]


@pytest.mark.cuda
def test_cuda_nccl_mesh_fit_past_int32_points(cuda, tmp_path):
    """A 1-rank NCCL mesh fits a block of 2^31 + 2^20 points, normalized
    (the global domain's MIN and MAX all-reduces, the map, the plain
    moments kernel past int32 indices, the SUM all-reduce): its excess
    SSE over the float64 least squares (``lsq``, the benchmark's sums
    added over rows of 2^20 points) stays inside the mesh cell's limit,
    and its count is exact."""
    import json
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.launch import mesh as mesh_lib
    lsq, bench = _perfbench_lsq()
    limit = json.loads((bench / "limits" / "mesh.colossal.json")
                       .read_text())["sse_excess"]
    n = (1 << 31) + (1 << 20)
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.rand(n, generator=g, device=cuda).mul_(4).sub_(2)
    y = torch.full_like(x, 0.75).mul_(x).add_(-0.2).mul_(x).add_(-1.0)
    y.mul_(x).add_(0.5)
    y.add_(torch.randn(n, generator=g, device=cuda), alpha=0.1)
    torch.cuda.set_device(cuda.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=120))
    try:
        K.reset_launch_counts()
        spec = api.FitSpec(degree=3,
                           numerics=api.NumericsPolicy(normalize=True))
        res = spec.distributed(mesh_lib.make_host_mesh(data=1))(x, y)
        assert K.launch_counts()["moments_plain"] == 1
        c = res.poly.coeffs.double().cpu().numpy()
        shift, scale = float(res.poly.domain_shift), float(
            res.poly.domain_scale)
        assert float(res.report.count) == n
    finally:
        dist.destroy_process_group()
    s = lsq.row_sums(x.view(-1, 1 << 20), y.view(-1, 1 << 20), 3)
    sums = lsq.Sums(s.s.sum(0), s.r.sum(0), s.yy.sum(0))
    del x, y, s
    c_ref = lsq.solve(sums, 0.0)
    got = torch.as_tensor(lsq.rebase(c, shift, scale, 0.0, 1.0),
                          device=cuda)
    excess = float(lsq.excess(sums, c_ref, lsq.sse(sums, c_ref), got))
    assert excess <= limit, excess


ZOO_ARCHS = ("dbrx-132b", "phi3.5-moe-42b-a6.6b", "internlm2-1.8b", "yi-6b",
             "qwen1.5-4b", "gemma2-27b", "llava-next-mistral-7b")


def _zoo(arch, compute_dtype):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import get_model
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              compute_dtype=compute_dtype)
    return cfg, get_model(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_cuda_zoo_matches_the_cpu(cuda, arch):
    """The same seeded weights on the card and on the CPU: forward_train,
    prefill and decode_step agree within 1e-5 of max|ref| at float32
    compute (TF32 off; two float32 orders of the same sums).  MoE
    configs' routing is a discrete choice on float32 probabilities, held
    by the same bar."""
    assert not torch.backends.cuda.matmul.allow_tf32
    import copy
    cfg, model = _zoo(arch, "float32")
    cpu_params = model.init_params(0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(cuda)   # Module.to moves
    assert next(cpu_params.parameters()).device.type == "cpu"
    g = np.random.default_rng(1)
    toks = torch.from_numpy(g.integers(3, cfg.vocab_size, (2, 32)))
    batch = {"tokens": toks}
    if cfg.n_image_tokens:
        batch["extra_embeds"] = torch.from_numpy(g.normal(
            0, 1, (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    on = lambda b, dev: {k: v.to(dev) for k, v in b.items()}

    def close(got, want):
        assert got.device.type == "cuda"
        got, want = got.float().cpu(), want.float()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err

    close(model.forward_train(gpu_params, on(batch, cuda))[0],
          model.forward_train(cpu_params, batch)[0])
    pre = dict(batch, tokens=toks[:, :-1])
    glog, gstate = model.prefill(gpu_params, on(pre, cuda), 40)
    clog, cstate = model.prefill(cpu_params, pre, 40)
    close(glog, clog)
    assert gstate["k"].device.type == "cuda"
    close(model.decode_step(gpu_params, toks[:, -1:].to(cuda), gstate)[0],
          model.decode_step(cpu_params, toks[:, -1:], cstate)[0])


@pytest.mark.cuda
def test_cuda_engine_serves_the_cpu_tokens(cuda):
    """Greedy serving of ragged requests past max_len (the clamp) on the
    card and on the CPU: the same tokens for every request."""
    import copy

    from repro_torch.serve import EngineConfig, ServeEngine
    cfg, model = _zoo("internlm2-1.8b", "float32")
    cpu_params = model.init_params(0, device="cpu")
    g = np.random.default_rng(2)
    prompts = [g.integers(3, 255, 5 + 4 * (i % 3)).tolist()
               for i in range(10)]
    outs = []
    for params in (cpu_params, copy.deepcopy(cpu_params).to(cuda)):
        eng = ServeEngine(model, params, EngineConfig(n_slots=4, max_len=24))
        reqs = [eng.submit(p, 4 + (5 * i) % 13, 0.0)
                for i, p in enumerate(prompts)]
        eng.run()
        assert all(r.done for r in reqs) and eng.stats["peak_len"] > 24
        assert eng.state["k"].device == next(params.parameters()).device
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_cuda_launch_serve_tokens_smoke(cuda, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--workload", "tokens", "--smoke"]) == 0
    assert "on cuda" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_cuda_train_step_matches_the_cpu(cuda, arch):
    """One train step from the same state on the card and on the CPU at
    float32 compute (TF32 off): loss and grad_norm within 1e-5 relative,
    mu (0.1 · the clipped gradient) within 1e-5 · max|mu|, the parameters
    within 2·lr + 1e-5 · max|p| (Adam's first step moves an element whose
    gradient is near 0 by ±lr, and two float32 orders of the same sum
    can give it either sign)."""
    import copy

    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    cfg, model = _zoo(arch, "float32")
    cpu = init_train_state(model, 0, device="cpu")
    gpu = copy.deepcopy(cpu)
    gpu["params"].to(cuda)
    gpu["opt"] = {"mu": {k: v.to(cuda) for k, v in cpu["opt"]["mu"].items()},
                  "nu": {k: v.to(cuda) for k, v in cpu["opt"]["nu"].items()},
                  "count": cpu["opt"]["count"].to(cuda)}
    gpu["step"] = cpu["step"].to(cuda)
    g = np.random.default_rng(3)
    st = 32 + cfg.n_image_tokens
    batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab_size,
                                                   (2, 32))),
             "labels": torch.from_numpy(g.integers(0, cfg.vocab_size,
                                                   (2, st))),
             "loss_mask": torch.ones(2, st)}
    if cfg.n_image_tokens:
        batch["extra_embeds"] = torch.from_numpy(g.normal(
            0, 1, (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    step = make_train_step(model, TrainConfig())
    cpu, cm = step(cpu, batch)
    gpu, gm = step(gpu, {k: v.to(cuda) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert gm[k].device.type == "cuda"
        assert abs(float(gm[k]) - float(cm[k])) <= 1e-5 * abs(float(cm[k]))
    lr = float(cm["lr"])
    for (n, p), (_, q) in zip(gpu["params"].named_parameters(),
                              cpu["params"].named_parameters()):
        err = (p.cpu() - q).abs().max().item()
        assert err <= 2 * lr + 1e-5 * q.abs().max().item(), n
        mu, want = gpu["opt"]["mu"][n].cpu(), cpu["opt"]["mu"][n]
        assert (mu - want).abs().max().item() <= \
            1e-5 * want.abs().max().item(), n


@pytest.mark.cuda
def test_cuda_launch_train_smoke_resumes(cuda, tmp_path, capsys):
    """The train launcher on the card: 8 steps with checkpoints at 4 and 8;
    with step 8's gone it resumes at 4 and replays the same losses (the
    reference's rtol 1e-5: the embedding's backward sums with atomics)."""
    import shutil

    from repro_torch.launch import train
    argv = ["--smoke", "--steps", "8", "--ckpt-every", "4",
            "--ckpt-dir", str(tmp_path), "--microbatches", "2"]
    whole = train.run(argv)
    assert "device=cuda" in capsys.readouterr().out
    shutil.rmtree(tmp_path / "step_00000008")
    resumed = train.run(argv)
    assert resumed["start_step"] == 4
    np.testing.assert_allclose([resumed["losses"][s] for s in range(4, 8)],
                               [whole["losses"][s] for s in range(4, 8)],
                               rtol=1e-5)


FAMILY_ARCHS = ("rwkv6-1.6b", "zamba2-7b", "whisper-base")


def _family_batch(cfg, b, s, seed):
    """Tokens (whisper: 24 frames and the decoder's tokens) and the key of
    the tokens."""
    g = np.random.default_rng(seed)
    toks = torch.from_numpy(g.integers(3, cfg.vocab_size, (b, s)))
    if cfg.family == "audio":
        return {"frames": torch.from_numpy(g.normal(
            0, 1, (b, 24, cfg.d_model)).astype(np.float32)),
            "dec_tokens": toks}, "dec_tokens"
    return {"tokens": toks}, "tokens"


def _state_tensors(state, prefix=""):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from _state_tensors(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + k, v


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_family_matches_the_cpu(cuda, arch):
    """The float32 checks of chip_smoke's 16a, 16d and 16e at the smoke
    configs: the same seeded weights on the card and on the CPU,
    forward_train, prefill and decode_step within 1e-5 of max|ref| (TF32
    off; two float32 orders of the same sums), every float32 leaf of the
    prefill state too, its bf16 leaves (K/V, shift inputs, whisper's
    encoder output) within one bf16 step (2⁻⁷).  Both decode from the
    CPU's prefill state (the card's copy of it): a bf16 leaf rounded to
    the neighbouring step on one device would otherwise move every
    product that reads it."""
    import copy
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _zoo(arch, "float32")
    cpu_params = model.init_params(0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(cuda)
    batch, key = _family_batch(cfg, 2, 32, 1)
    on = lambda b, dev: {k: v.to(dev) for k, v in b.items()}

    def close(name, got, want, tol=1e-5):
        assert got.device.type == "cuda", name
        got, want = got.float().cpu(), want.float()
        err = (got - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (name, err)

    close("forward_train", model.forward_train(gpu_params, on(batch, cuda))[0],
          model.forward_train(cpu_params, batch)[0])
    pre = dict(batch, **{key: batch[key][:, :-1]})
    glog, gstate = model.prefill(gpu_params, on(pre, cuda), 40)
    clog, cstate = model.prefill(cpu_params, pre, 40)
    close("prefill", glog, clog)
    cleaves = dict(_state_tensors(cstate))
    for name, t in _state_tensors(gstate):
        close(name, t, cleaves[name], 2.0 ** -7 if t.dtype == torch.bfloat16
              else 1e-5)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else
                v.to(cuda) if isinstance(v, torch.Tensor) else v
                for k, v in tree.items()}

    tok = batch[key][:, -1:]
    gdec = model.decode_step(gpu_params, tok.to(cuda), to_card(cstate))[0]
    close("decode_step", gdec, model.decode_step(cpu_params, tok, cstate)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_family_prefill_decode_match_forward_train(cuda, arch):
    """The bf16 consistency of chip_smoke's 16a, 16d and 16e at the smoke
    configs, on the card: prefill of s - 1 tokens on the compute copy and
    one decode step against forward_train of s, within the reference's
    5e-2 of max|ref|."""
    cfg, model = _zoo(arch, "bfloat16")
    params = model.init_params(0, device=cuda)
    cp = model.compute_params(params)
    batch, key = _family_batch(cfg, 2, 24, 2)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    full, _ = model.forward_train(params, batch)
    logits, state = model.prefill(cp, dict(batch, **{key: batch[key][:, :-1]}),
                                  32)
    dec, state = model.decode_step(cp, batch[key][:, -1:], state)
    for got, want in ((logits[:, 0], full[:, -2]), (dec[:, 0], full[:, -1])):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item(), err
    assert all(t.device.type == "cuda" for _, t in _state_tensors(state))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("rwkv6-1.6b", "zamba2-7b"))
def test_cuda_family_engine_serves_the_cpu_tokens(cuda, arch):
    """Greedy serving of ragged requests past max_len on the card and on
    the CPU at float32: the same tokens for every request, the pooled
    recurrent state (and zamba2's shared K/V) on the card."""
    import copy

    from repro_torch.serve import EngineConfig, ServeEngine
    cfg, model = _zoo(arch, "float32")
    cpu_params = model.init_params(0, device="cpu")
    g = np.random.default_rng(2)
    prompts = [g.integers(3, 255, 5 + 4 * (i % 3)).tolist()
               for i in range(10)]
    outs = []
    for params in (cpu_params, copy.deepcopy(cpu_params).to(cuda)):
        eng = ServeEngine(model, params, EngineConfig(n_slots=4, max_len=24))
        reqs = [eng.submit(p, 4 + (5 * i) % 13, 0.0)
                for i, p in enumerate(prompts)]
        eng.run()
        assert all(r.done for r in reqs) and eng.stats["peak_len"] > 24
        dev = next(params.parameters()).device
        assert all(t.device == dev for _, t in _state_tensors(eng.state))
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
