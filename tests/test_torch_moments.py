"""Port parity: ``repro_torch.core.moments`` and ``repro_torch.kernels.ref``
against the JAX reference, on the CPU with seeded numpy inputs.

Tolerances: sums of n <= 300 terms in a different order — f32 rtol 2e-5
(atol 1e-3 on entries that cancel), f64 rtol 1e-11."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moments as jm
from repro.kernels import ref as jref
from repro_torch.core import moments as tm
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

FIELDS = ("gram", "vty", "yty", "count", "weight_sum")
DTYPES = [(np.float32, 2e-5, 1e-3), (np.float64, 1e-11, 1e-9)]


def _data(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, shape).astype(dtype),
            rng.normal(0, 1, shape).astype(dtype))


def _weights(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.2, 2.0, shape) * (rng.uniform(size=shape) > 0.3)
    return w.astype(dtype)


def _close(tmom, jmom, rtol, atol):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tmom, f).double().numpy(),
                                   np.asarray(getattr(jmom, f), np.float64),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("npd,rtol,atol", DTYPES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("basis", ["monomial", "chebyshev"])
def test_gram_moments(npd, rtol, atol, weighted, basis):
    x, y = _data(0, (3, 97), npd)
    w = _weights(1, (3, 97), npd) if weighted else None
    with jax.enable_x64(npd == np.float64):
        ref = jm.gram_moments(jnp.asarray(x), jnp.asarray(y), 4, basis=basis,
                              weights=None if w is None else jnp.asarray(w))
        ref = jax.tree.map(np.asarray, ref)
    got = tm.gram_moments(torch.from_numpy(x), torch.from_numpy(y), 4,
                          basis=basis,
                          weights=None if w is None else torch.from_numpy(w))
    _close(got, ref, rtol, atol)
    if weighted:   # true count of nonzero weights, Σw kept apart
        np.testing.assert_array_equal(got.count.numpy(), (w != 0).sum(-1))
        assert not np.allclose(got.count.numpy(), got.weight_sum.numpy())


def test_gram_moments_accum_dtype_widens():
    x, y = _data(2, (2, 50))
    got = tm.gram_moments(torch.from_numpy(x), torch.from_numpy(y), 3,
                          accum_dtype=torch.float64)
    assert got.gram.dtype == torch.float64
    assert got.count.dtype == torch.float64


@pytest.mark.parametrize("block", [16, 64, 1000])
def test_gram_moments_blocked(block):
    x, y = _data(3, (2, 150))
    ref = jax.tree.map(np.asarray, jm.gram_moments_blocked(
        jnp.asarray(x), jnp.asarray(y), 3, block=block))
    got = tm.gram_moments_blocked(torch.from_numpy(x), torch.from_numpy(y), 3,
                                  block=block)
    _close(got, ref, 2e-5, 1e-3)


def test_moments_ops():
    x, y = _data(4, (2, 40), np.float64)
    with jax.enable_x64(True):
        j1 = jm.gram_moments(jnp.asarray(x[:, :20]), jnp.asarray(y[:, :20]), 3)
        j2 = jm.gram_moments(jnp.asarray(x[:, 20:]), jnp.asarray(y[:, 20:]), 3)
        js = jax.tree.map(np.asarray, j1 + j2)
        jr = jax.tree.map(np.asarray, js_reg := (j1 + j2).regularized(0.5))
        jt = jax.tree.map(np.asarray, js_reg.truncate(1))
        jcond = np.asarray((j1 + j2).condition())
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    t1 = tm.gram_moments(tx[:, :20], ty[:, :20], 3)
    t2 = tm.gram_moments(tx[:, 20:], ty[:, 20:], 3)
    ts = t1 + t2
    _close(ts, js, 1e-12, 1e-10)
    _close(ts.regularized(0.5), jr, 1e-12, 1e-10)
    _close(ts.regularized(0.5).truncate(1), jt, 1e-12, 1e-10)
    assert ts.degree == 3 and ts.truncate(2).degree == 2
    np.testing.assert_allclose(ts.condition().numpy(), jcond, rtol=1e-6)
    with pytest.raises(ValueError):
        ts.truncate(4)
    z = tm.Moments.zeros(2, (3,), dtype=torch.float64)
    assert z.gram.shape == (3, 3, 3) and float(z.gram.abs().sum()) == 0.0
    z1 = tm.Moments.zeros(3, (2,), dtype=torch.float64)
    _close(z1 + ts, js, 1e-12, 1e-10)


@pytest.mark.parametrize("npd", [np.float32, np.float64])
def test_decay_ladder(npd):
    with jax.enable_x64(npd == np.float64):
        ref = np.asarray(jm.decay_ladder(37, 0.93, npd))
    got = tm.decay_ladder(37, 0.93, getattr(torch, np.dtype(npd).name))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert float(got[-1]) == 1.0


def test_power_sums_hankel_and_moment_vector():
    x, y = _data(5, (60,), np.float64)
    with jax.enable_x64(True):
        s = jm.power_sums(jnp.asarray(x), 3)
        h = np.asarray(jm.hankel_from_power_sums(s, 3))
        b = np.asarray(jm.moment_vector(jnp.asarray(x), jnp.asarray(y), 3))
        s = np.asarray(s)
    ts = tm.power_sums(torch.from_numpy(x), 3)
    np.testing.assert_allclose(ts.numpy(), s, rtol=1e-12)
    np.testing.assert_allclose(tm.hankel_from_power_sums(ts, 3).numpy(), h,
                               rtol=1e-12)
    np.testing.assert_allclose(
        tm.moment_vector(torch.from_numpy(x), torch.from_numpy(y), 3).numpy(),
        b, rtol=1e-12)
    # the paper's identity: Hankel of power sums == VᵀV
    g = tm.gram_moments(torch.from_numpy(x), torch.from_numpy(y), 3).gram
    np.testing.assert_allclose(g.numpy(), h, rtol=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("degree", [0, 3, 9])
def test_ref_extended_gram_full_tile(weighted, degree):
    x, y = _data(6, (2, 70))
    w = _weights(7, (2, 70)) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    ref = np.asarray(jref.extended_gram(jnp.asarray(x), jnp.asarray(y),
                                        degree, jw))
    got = tref.extended_gram(torch.from_numpy(x), torch.from_numpy(y), degree,
                             tw)
    assert got.shape == (2, tref.K_PAD, tref.K_PAD)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=1e-3)
    refm = jax.tree.map(np.asarray, jref.moments_reference(
        jnp.asarray(x), jnp.asarray(y), degree, jw))
    _close(tref.moments_reference(torch.from_numpy(x), torch.from_numpy(y),
                                  degree, tw), refm, 2e-5, 1e-3)


@pytest.mark.parametrize("weighted", [False, True])
def test_ref_packed_extended_gram_full_tile(weighted):
    degree = 3
    p = tref.K_PAD // (degree + 2)
    x, y = _data(8, (2, p, 40))
    w = _weights(9, (2, p, 40)) if weighted else None
    ref = np.asarray(jref.packed_extended_gram(
        jnp.asarray(x), jnp.asarray(y), degree,
        None if w is None else jnp.asarray(w)))
    got = tref.packed_extended_gram(
        torch.from_numpy(x), torch.from_numpy(y), degree,
        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=1e-3)
