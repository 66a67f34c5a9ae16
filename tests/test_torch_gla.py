"""The port's chunked gated linear recurrence against the reference's
``chunked_gla`` itself, on the CPU, across decay regimes (Mamba2-extreme
included), both modes, chunk sizes, a ragged length, scalar decays, the
carried state and decode steps; and its backward against autograd
through the port's own step-by-step ``reference_recurrence``.

Bar: float32, max|Δ| <= max(1e-5, eps32 · max|cum|) · max|ref|, where
cum is the chunk's cumulative log-decay.  Both packages compute
cum_t - cum_s and exponentiate it; their cumsums associate the chunk's
terms in other orders, so cum differs by a few ulps of |cum| between
them, and in "bonus" mode the q-side cum_t - logw_t cancels to within
that rounding (a factor e^{±δ} on the adjacent score).  For the decays
below 1 this is the 1e-5 bar itself; at decay 8 with chunks of 64,
|cum| reaches ≈ 700 and eps32·|cum| ≈ 8e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import gla as rgla
from repro_torch.models import gla

torch.set_num_threads(1)

F32_TOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def _inputs(seed, b, h, t, dk, dv, decay_scale, scalar_decay=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, t, dk)).astype(np.float32)
    k = rng.normal(0, 1, (b, h, t, dk)).astype(np.float32)
    v = rng.normal(0, 1, (b, h, t, dv)).astype(np.float32)
    shape = (b, h, t, 1) if scalar_decay else (b, h, t, dk)
    logw = (-np.abs(rng.normal(decay_scale, decay_scale / 2, shape))
            ).astype(np.float32)
    u = rng.normal(0, 1, (h, dk)).astype(np.float32)
    return q, k, v, logw, u


def _tol(logw, chunk):
    """The bar's scale: eps32 times the largest |cumsum| of logw within a
    chunk (the tail chunk included), or 1e-5 where that is smaller."""
    t = logw.shape[2]
    pad = (-t) % chunk
    lw = np.pad(logw, ((0, 0), (0, 0), (0, pad), (0, 0)))
    lw = lw.reshape(lw.shape[:2] + (-1, chunk, lw.shape[-1]))
    cum = np.abs(np.cumsum(lw.astype(np.float64), axis=3)).max()
    return max(F32_TOL, EPS32 * cum)


def close(got, want, tol=F32_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), \
        f"max|Δ| {err:.3e} > {tol:.3e}·{np.abs(want).max():.3e}"


def _both(q, k, v, logw, u, mode, chunk, initial_state=None):
    ry, rs = rgla.chunked_gla(
        *map(jnp.asarray, (q, k, v, logw)), u=jnp.asarray(u),
        initial_state=None if initial_state is None
        else jnp.asarray(initial_state), chunk=chunk, mode=mode)
    ty, ts = gla.chunked_gla(
        *map(torch.from_numpy, (q, k, v, logw)), u=torch.from_numpy(u),
        initial_state=None if initial_state is None
        else torch.from_numpy(initial_state), chunk=chunk, mode=mode)
    return (ry, rs), (ty, ts)


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("decay", [0.05, 1.0, 8.0])
@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_matches_the_reference(mode, decay, chunk):
    """A ragged T (117: the tail chunk padded inertly); the output, the
    final state and their dtypes against the reference's chunked_gla."""
    q, k, v, logw, u = _inputs(0, 2, 2, 117, 16, 8, decay)
    (ry, rs), (ty, ts) = _both(q, k, v, logw, u, mode, chunk)
    tol = _tol(logw, chunk)
    close(ty, ry, tol)
    close(ts, rs, tol)
    assert ty.dtype == ts.dtype == torch.float32
    assert bool(torch.isfinite(ty).all())


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_scalar_decay_broadcast(mode):
    """Mamba2-style per-head scalar decay (logw's last axis 1)."""
    q, k, v, logw, u = _inputs(1, 2, 3, 64, 16, 16, 6.0, scalar_decay=True)
    (ry, rs), (ty, ts) = _both(q, k, v, logw, u, mode, 32)
    close(ty, ry, _tol(logw, 32))
    close(ts, rs, _tol(logw, 32))


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_state_carry_across_calls(mode):
    """Two halves with the carried state equal one call (prefill), and the
    second half from a carried state equals the reference's."""
    q, k, v, logw, u = _inputs(2, 1, 2, 128, 8, 8, 0.5)
    t = lambda a: torch.from_numpy(a)
    y, s = gla.chunked_gla(t(q), t(k), t(v), t(logw), u=t(u), chunk=32,
                           mode=mode)
    half = 64
    cut = lambda a, lo, hi: t(np.ascontiguousarray(a[:, :, lo:hi]))
    ya, sa = gla.chunked_gla(*(cut(a, 0, half) for a in (q, k, v, logw)),
                             u=t(u), chunk=32, mode=mode)
    yb, sb = gla.chunked_gla(*(cut(a, half, None) for a in (q, k, v, logw)),
                             u=t(u), initial_state=sa, chunk=32, mode=mode)
    close(torch.cat([ya, yb], 2), y.numpy())
    close(sb, s.numpy())
    (ry, rs), (ty, ts) = _both(
        *(np.ascontiguousarray(a[:, :, half:]) for a in (q, k, v, logw)),
        u, mode, 32, initial_state=sa.numpy())
    close(ty, ry)
    close(ts, rs)


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_decode_steps_match_chunked(mode):
    """T decode steps equal the chunked pass (train/serve parity), and each
    step equals the reference's ``gla_decode_step``."""
    tl = 32
    q, k, v, logw, u = _inputs(3, 1, 2, tl, 8, 8, 0.3)
    y_train, _ = gla.chunked_gla(*map(torch.from_numpy, (q, k, v, logw)),
                                 u=torch.from_numpy(u), chunk=16, mode=mode)
    state = torch.zeros((1, 2, 8, 8))
    rstate = jnp.zeros((1, 2, 8, 8), jnp.float32)
    outs = []
    for i in range(tl):
        at = [a[:, :, i] for a in (q, k, v, logw)]
        yi, state = gla.gla_decode_step(*map(torch.from_numpy, at), state,
                                        u=torch.from_numpy(u), mode=mode)
        ryi, rstate = rgla.gla_decode_step(*map(jnp.asarray, at), rstate,
                                           u=jnp.asarray(u), mode=mode)
        close(yi, ryi)
        close(state, rstate)
        outs.append(yi)
    close(torch.stack(outs, dim=2), y_train.detach().numpy())


def test_reference_recurrence_matches_the_references():
    q, k, v, logw, u = _inputs(4, 1, 2, 40, 8, 4, 1.0)
    for mode in ("inclusive", "bonus"):
        ry, rs = rgla.reference_recurrence(*map(jnp.asarray,
                                                (q, k, v, logw)),
                                           u=jnp.asarray(u), mode=mode)
        ty, ts = gla.reference_recurrence(*map(torch.from_numpy,
                                               (q, k, v, logw)),
                                          u=torch.from_numpy(u), mode=mode)
        close(ty, ry)
        close(ts, rs)


def test_bf16_inputs_keep_float32_math():
    """bf16 q/k/v: float32 math, the output cast back to bf16, the state
    float32; against the reference on the same bf16 values."""
    q, k, v, logw, u = _inputs(5, 1, 2, 48, 16, 16, 0.5)
    rb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    ry, rs = rgla.chunked_gla(*rb, jnp.asarray(logw), u=jnp.asarray(u),
                              chunk=16, mode="bonus")
    ty, ts = gla.chunked_gla(*tb, torch.from_numpy(logw),
                             u=torch.from_numpy(u), chunk=16, mode="bonus")
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    close(ts, rs)
    close(ty.float(), np.asarray(ry, np.float32), 2.0 ** -7)


def test_unknown_mode_raises():
    q, k, v, logw, u = map(torch.from_numpy, _inputs(0, 1, 1, 8, 4, 4, 1.0))
    with pytest.raises(ValueError):
        gla.chunked_gla(q, k, v, logw, mode="exclusive")


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("decay", [0.05, 6.0])
def test_backward_matches_autograd_through_the_recurrence(mode, decay):
    """Gradients of a loss on (y, final state) with respect to q, k, v,
    logw (and u in "bonus" mode) through the chunked form, against
    autograd through ``reference_recurrence`` (one step at a time):
    float32 within the file's bar of each gradient's largest element."""
    q, k, v, logw, u = _inputs(6, 1, 2, 40, 8, 8, decay)
    rng = np.random.default_rng(7)
    wy = torch.from_numpy(rng.normal(0, 1, (1, 2, 40, 8)).astype(np.float32))
    ws = torch.from_numpy(rng.normal(0, 1, (1, 2, 8, 8)).astype(np.float32))

    def grads(fn, **kw):
        leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (q, k, v, logw, u)]
        y, s = fn(*leaves[:4], u=leaves[4], mode=mode, **kw)
        loss = (y * wy).sum() + (s * ws).sum()
        # "inclusive" reads no bonus
        return torch.autograd.grad(
            loss, leaves if mode == "bonus" else leaves[:4])

    got = grads(gla.chunked_gla, chunk=16)
    want = grads(gla.reference_recurrence)
    tol = _tol(logw, 16)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        close(g, w.numpy(), tol)


settings.register_profile("torch_gla", deadline=None, max_examples=30)


@settings(settings.get_profile("torch_gla"))
@given(st.integers(0, 10_000), st.sampled_from([16, 32]),
       st.floats(0.01, 10.0), st.sampled_from(["inclusive", "bonus"]))
def test_property_sweep(seed, chunk, decay, mode):
    q, k, v, logw, u = _inputs(seed, 1, 1, 50, 8, 4, decay)
    (ry, rs), (ty, ts) = _both(q, k, v, logw, u, mode, chunk)
    close(ty, ry, _tol(logw, chunk))
    close(ts, rs, _tol(logw, chunk))
