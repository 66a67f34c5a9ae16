"""The port's AdamW against the reference's, on the CPU.

The same random trees (numpy, from a seed) go through both packages.
Tolerance: rtol 1e-6 in float32 (the same expression per element; XLA
may contract a multiply-add the port rounds twice, one float32 ulp) and
1e-12 in float64 (the gradients, the global norm and the schedule are
float32 in both packages, as the reference casts them; the moments and
the parameters are float64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ropt
from repro_torch.train import optimizer as topt
from repro_torch.tree import named_leaves

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _tree(seed, dtype, scale=1.0):
    """Keys in sorted order: JAX flattens a dict by sorted keys, the port
    by insertion order, so the leaves line up."""
    r = np.random.default_rng(seed)
    return {"blocks": [{"a": r.normal(0, scale, (3,)).astype(dtype),
                        "b": r.normal(0, scale, (4, 2, 3)).astype(dtype)},
                       {"a": r.normal(0, scale, (3,)).astype(dtype),
                        "b": r.normal(0, scale, (4, 2, 3)).astype(dtype)}],
            "scalar": np.asarray(r.normal(0, scale), dtype),
            "w": (r.normal(0, scale, (7, 5))).astype(dtype)}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    return [t.numpy() for _, t in named_leaves(tree)]


def test_schedule_matches_the_reference_at_many_steps():
    steps = np.arange(0, 12_001, 7)
    for cfg in (topt.AdamWConfig(),
                topt.AdamWConfig(peak_lr=3e-3, warmup_steps=20,
                                 total_steps=200, min_lr_ratio=0.0),
                topt.AdamWConfig(warmup_steps=0, total_steps=1)):
        rcfg = ropt.AdamWConfig(**{f: getattr(cfg, f) for f in
                                   cfg.__dataclass_fields__})
        got = topt.schedule(cfg, torch.from_numpy(steps.astype(np.int32)))
        want = np.asarray(ropt.schedule(rcfg, jnp.asarray(steps, jnp.int32)))
        assert got.dtype == torch.float32
        # the two float32 cosines may differ by an ulp of 1 (2^-24); where
        # 1 + cos(πt) cancels to near 0 that is absolute, times 0.5·peak
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=cfg.peak_lr * 2.0 ** -24)
    assert float(topt.schedule(topt.AdamWConfig(), 0)) == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_matches_the_reference(dtype, seed):
    tree = _tree(seed, dtype, scale=3.0)
    with jax.enable_x64(dtype == np.float64):
        want = float(ropt.global_norm(_to_jax(tree)))
    got = topt.global_norm(_to_torch(tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("clip", [None, 1.0, 1e3])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_apply_updates_matches_the_reference(dtype, clip, weight_decay):
    """Five steps of AdamW from zero moments on random trees (gradients of
    norm ≈ 9, so a clip of 1 binds and 1e3 does not): params, mu, nu,
    count, grad_norm and lr after every step."""
    cfg = topt.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                           clip_norm=clip, weight_decay=weight_decay)
    rcfg = ropt.AdamWConfig(**{f: getattr(cfg, f) for f in
                               cfg.__dataclass_fields__})
    params = _tree(10, dtype)
    tp = _to_torch(params)
    ts = topt.init_state(tp)
    with jax.enable_x64(dtype == np.float64):
        rp = _to_jax(params)
        rs = ropt.init_state(rp)
        for step in range(5):
            grads = _tree(20 + step, dtype, scale=2.0)
            rp, rs, rm = ropt.apply_updates(rcfg, rp, _to_jax(grads), rs)
            tp2, ts, tm = topt.apply_updates(cfg, tp, _to_torch(grads), ts)
            assert tp2 is tp                              # in place
            tol = TOL[dtype]
            for got, want in zip(_leaves(tp), jax.tree.leaves(rp)):
                assert got.dtype == np.asarray(want).dtype
                np.testing.assert_allclose(got, np.asarray(want), rtol=tol,
                                           atol=tol * 1e-3)
            for key in ("mu", "nu"):
                for got, want in zip(_leaves(ts[key]),
                                     jax.tree.leaves(rs[key])):
                    np.testing.assert_allclose(got, np.asarray(want),
                                               rtol=tol, atol=tol * 1e-6)
            assert int(ts["count"]) == int(rs["count"]) == step + 1
            for key in ("grad_norm", "lr"):
                np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                           rtol=1e-6)


def test_apply_updates_on_a_module_keys_moments_by_parameter_name():
    lin = torch.nn.Linear(3, 2)
    st = topt.init_state(lin)
    assert set(st["mu"]) == {"weight", "bias"} and st["count"].dtype == \
        torch.int32
    before = lin.weight.detach().clone()
    grads = {"weight": torch.ones(2, 3), "bias": torch.ones(2)}
    _, st, m = topt.apply_updates(topt.AdamWConfig(warmup_steps=0), lin,
                                  grads, st)
    assert not torch.equal(lin.weight, before)
    assert float(m["grad_norm"]) == pytest.approx(np.sqrt(8.0))
    with pytest.raises(ValueError):
        topt.apply_updates(topt.AdamWConfig(), lin,
                           {"weight": grads["weight"]}, st)
