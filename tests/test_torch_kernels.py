"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU the port's wrappers run the kernels' plain versions (a CPU
tensor is the only reason they do); the reference's Pallas kernels run in
interpret mode at tiny shapes (B ∈ {1, 3, 26}, n <= 300, block_n=128).
Tolerance: float32 sums of <= 300 terms in another order, rtol 2e-5 with
atol 1e-3 on entries that cancel (bf16 inputs: rtol 1e-4, atol 5e-2).
The CUDA kernels themselves are tested on the card by
``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import moments as K
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

FIELDS = ("gram", "vty", "yty", "count", "weight_sum")


def _data(seed, shape, zero_weights=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, shape).astype(np.float32)
    y = rng.normal(0, 1, shape).astype(np.float32)
    w = None
    if zero_weights:
        w = (rng.uniform(0.2, 2.0, shape)
             * (rng.uniform(size=shape) > 0.3)).astype(np.float32)
    return x, y, w


def _close(tm, jm, rtol=2e-5, atol=1e-3):
    for f in FIELDS:
        got = getattr(tm, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(getattr(jm, f), np.float64),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("b,n,degree,packing,weighted,compensated", [
    (1, 300, 3, "plain", False, False),
    (1, 6, 0, "auto", False, True),
    (3, 257, 7, "plain", True, False),
    (3, 200, 7, "packed", False, True),
    (26, 150, 3, "auto", True, False),      # 25 per tile + a tail series
    (3, 130, 20, "auto", False, False),
])
def test_moments_against_pallas(b, n, degree, packing, weighted,
                                compensated):
    x, y, w = _data(b * n + degree, (b, n), weighted)
    jm = jops.moments(jnp.asarray(x), jnp.asarray(y), degree,
                      weights=None if w is None else jnp.asarray(w),
                      block_n=128, packing=packing, compensated=compensated,
                      interpret=True)
    tm = ops.moments(x, y, degree, weights=w, packing=packing,
                     compensated=compensated, device="cpu")
    _close(tm, jm)
    if weighted:   # true count, not Σw
        np.testing.assert_array_equal(tm.count.numpy(), (w != 0).sum(-1))


def test_moments_bf16_and_flat_input():
    x, y, _ = _data(5, (2, 140))
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    jm = jops.moments(xb, yb, 3, block_n=128, interpret=True)
    tm = ops.moments(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(y).bfloat16(), 3, device="cpu")
    _close(tm, jm, rtol=1e-4, atol=5e-2)
    jf = jops.moments(jnp.asarray(x[0]), jnp.asarray(y[0]), 3, block_n=128,
                      interpret=True)
    tf = ops.moments(x[0], y[0], 3, device="cpu")
    assert tf.gram.shape == (4, 4) and tf.yty.ndim == 0
    _close(tf, jf)


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_report_sums_against_pallas(weighted):
    x, y, w = _data(6, (3, 300), weighted)
    c = np.random.default_rng(7).normal(size=(3, 4)).astype(np.float32)
    js = jops.fused_report_sums(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(c),
                                weights=None if w is None else jnp.asarray(w),
                                block_n=128, interpret=True)
    ts = ops.fused_report_sums(x, y, c, weights=w, device="cpu")
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].double().numpy(),
                                   np.asarray(js[k], np.float64), rtol=2e-5,
                                   atol=1e-3, err_msg=k)
    flat = ops.fused_report_sums(x[0], y[0], c[0], device="cpu")
    assert flat["sse"].ndim == 0


def test_plain_versions_equal_the_reference_oracle_blocks():
    x, y, w = _data(8, (3, 90), True)
    tx, ty, tw = map(torch.from_numpy, (x, y, w))
    g = K.moments_block_plain(tx, ty, tw, 5)
    full = ref.extended_gram(tx, ty, 5, tw)
    np.testing.assert_allclose(g.numpy(), full[:, :7, :7].numpy(),
                               rtol=1e-5, atol=1e-4)
    assert float(full[:, 7:, :].abs().max()) == 0.0   # padding rows zero


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    K.reset_launch_counts()
    x, y, _ = _data(9, (2, 50))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    K.moments_plain(tx, ty, degree=2)
    K.moments_packed(tx, ty, degree=2)
    K.moments_packed_ring(tx, ty, degree=2, block_n=32, nbuf=2)
    K.fused_report(tx, ty, None, torch.zeros(2, 3))
    assert K.launch_counts() == {"moments_plain": 0, "moments_packed": 0,
                                 "moments_packed_ring": 0,
                                 "fused_report": 0, "solve_small": 0}


def test_nbuf_and_packing_validation():
    x, y, _ = _data(10, (2, 20))
    m0 = ops.moments(x, y, 3, device="cpu")
    m2 = ops.moments(x, y, 3, nbuf=2, device="cpu")
    m3 = ops.moments(x, y, 3, nbuf=3, block_n=64, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(m0, f), getattr(m2, f)), f
        assert torch.equal(getattr(m0, f), getattr(m3, f)), f
    with pytest.raises(ValueError):
        ops.moments(x, y, 3, nbuf=1, device="cpu")
    with pytest.raises(ValueError):
        ops.moments(x, y, 3, nbuf=-2, device="cpu")
    with pytest.raises(ValueError, match="plain"):
        ops.moments(x, y, 3, nbuf=2, packing="plain", device="cpu")
    with pytest.raises(ValueError, match="plain"):
        ops.moments(x[0], y[0], 3, nbuf=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.moments(x, y, 3, nbuf=2, block_n=100, device="cpu")
    with pytest.raises(ValueError):
        ops.moments(x, y, 3, packing="tiled", device="cpu")
    with pytest.raises(ValueError):
        ops.moments(x, y, 70, packing="packed", device="cpu")
    with pytest.raises(ValueError):
        ops.fused_report_sums(x, y, np.zeros((2, 129), np.float32),
                              device="cpu")


def test_build_command_targets_sm90a_without_fast_math(tmp_path):
    srcs = build.sources()
    assert [s.name for s in srcs] == ["moments.cu", "moments_ring.cu",
                                      "solve.cu"]
    objs = [tmp_path / f"{s.stem}.o" for s in srcs]
    for src, obj in zip(srcs, objs):
        cmd = build.compile_command(src, obj, "nvcc")
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined
        assert "-O3" in cmd and "-c" in cmd and cmd[-1] == str(src)
        assert "fast_math" not in joined and "fast-math" not in joined
    link = build.link_command(objs, tmp_path / "lib.so", "nvcc")
    assert "-shared" in link and link[-len(objs):] == [str(o) for o in objs]
    assert "fast_math" not in " ".join(link)
    assert [h.name for h in build.headers()] == ["moments_common.cuh"]
    assert build.library_path().parent == build.BUILD_DIR
    assert build.library_path().name.startswith("librepro_kernels_")


@pytest.mark.parametrize("b,n,tasks_per_cta", [
    (1, 1 << 28, 1), (4096, 1 << 16, 8), (2, 1 << 28, 8), (64, 77, 1),
    (3, 5000, 1)])
def test_splits_fill_the_card_and_stay_deterministic(b, n, tasks_per_cta):
    s = K.splits(b, n, tasks_per_cta, 132)
    assert s == K.splits(b, n, tasks_per_cta, 132)
    assert 1 <= s <= max(1, -(-n // K.MIN_SPLIT_POINTS))
    if n >= K.MIN_SPLIT_POINTS * 1056:
        assert b * s >= K.CTAS_PER_SM * 132 * tasks_per_cta


def test_kernel_plan_takes_multi_axis_batches():
    """A kernel plan on a (3, 4, n) batch flattens the leading axes for
    the kernel and restores them on every field (the fold pass of degree
    selection hands the kernel (k, ..., n/k)).  Held against the
    reference's jnp moments on the same inputs; rtol 2e-5, atol 1e-3 as
    above."""
    from repro import core as jcore
    from repro_torch import engine
    x, y, w = _data(12, (3, 4, 90), zero_weights=True)
    jm = jcore.gram_moments(jnp.asarray(x), jnp.asarray(y), 3,
                            weights=jnp.asarray(w))
    for path in ("kernel_packed", "kernel_plain"):
        plan = engine.plan_fit(x.shape, 3, engine=path, device="cpu")
        tm = engine.compute_moments(plan, torch.from_numpy(x),
                                    torch.from_numpy(y), torch.from_numpy(w))
        assert tm.gram.shape == (3, 4, 4, 4) and tm.count.shape == (3, 4)
        _close(tm, jm)
    tm = ops.moments(x, y, 3, weights=w[0], packing="packed", nbuf=2,
                     block_n=32, device="cpu")
    assert tm.weight_sum.shape == (3, 4)
    np.testing.assert_allclose(tm.weight_sum.numpy(),
                               np.broadcast_to(w[0].sum(-1), (3, 4)),
                               rtol=1e-6)
