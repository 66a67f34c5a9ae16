"""The model zoo on the port against the JAX reference, on the CPU.

Weights are the reference's (``jax.random``), carried into the port with
``interop.model_params`` (or, for one block, loaded field by field), and
both packages run the same numpy inputs.  Tolerances:

* float32 compute: max|Δ| <= 1e-5 · max|ref| (two float32 orders of the
  same sums);
* the configs' own bf16 compute: max|Δ| <= 5e-2 · max|ref|, the
  reference's own 5e-2 bar for bf16 paths (``tests/test_arch_smoke.py``)
  taken against the largest value, as the float32 bar is: bf16 steps of
  1/8 at logits of 16–32 put near-zero elements outside an elementwise
  5e-2 when the two packages sum in different orders;
* a bf16 KV cache written from float32 compute: max|Δ| <= 2⁻⁷ · max|ref|,
  one bf16 step (at most 2⁻⁷ of the value), since float32 K/V that differ
  in their last bits may round to neighbouring bf16 values; from bf16
  compute, the bf16 bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import common as rcm
from repro.models import get_model as rget_model
from repro.models import mlp as rmlp
from repro.models import moe as rmoe
from repro.models import transformer as rtf
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import get_model as tget_model
from repro_torch.models import mlp as tmlp
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

CPU = "cpu"
F32_TOL = 1e-5
BF16_TOL = 5e-2
CACHE_TOL = 2.0 ** -7
TRANSFORMER_ARCHS = [a for a in rconfigs.ARCHS
                     if rconfigs.get_config(a).family in ("dense", "moe",
                                                          "vlm")]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close_f32(got, want, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"max|Δ| {err:.3e} > {tol:g}·{scale:.3e}"


def close_bf16(got, want):
    close_f32(got, want, BF16_TOL)


def pair(x, dtype):
    """One float32 numpy array as the same values in both packages."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    return jnp.asarray(x, jnp.float32).astype(jdt), \
        torch.from_numpy(np.asarray(x, np.float32)).to(tdt)


def load(mod, tree):
    """A reference parameter dict as ``mod``'s parameters (float32)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            load(getattr(mod, k), v)
        else:
            setattr(mod, k, torch.nn.Parameter(
                torch.from_numpy(np.array(v, np.float32)),
                requires_grad=False))
    return mod


def _rng(seed):
    return np.random.default_rng(seed)


CLOSE = {"float32": close_f32, "bfloat16": close_bf16}


# ----------------------------------------------------------------- common
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_embed_parity(dtype):
    r = _rng(0)
    x = r.normal(0, 2, (2, 7, 4, 16))
    jx, tx = pair(x, dtype)
    scale = r.normal(0, 0.3, 16).astype(np.float32)
    bias = r.normal(0, 0.3, 16).astype(np.float32)
    rn = load(tcm.RMSNorm(16, device="meta"), {"scale": scale})
    ln = load(tcm.LayerNorm(16, device="meta"), {"scale": scale,
                                                   "bias": bias})
    CLOSE[dtype](tcm.rmsnorm(rn, tx), rcm.rmsnorm({"scale": scale}, jx))
    CLOSE[dtype](tcm.layernorm(ln, tx),
                 rcm.layernorm({"scale": scale, "bias": bias}, jx))
    pos = r.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (10000.0, 1e6):
        CLOSE[dtype](tcm.apply_rope(tx, torch.from_numpy(pos), theta),
                     rcm.apply_rope(jx, jnp.asarray(pos), theta))
    table = r.normal(0, 1, (50, 16)).astype(np.float32)
    emb = load(tcm.Embedding(50, 16, device="meta"), {"table": table})
    h = x[:, :, 0, :]
    jh, th = pair(h, dtype)
    for cap in (None, 30.0):
        CLOSE[dtype](tcm.embed_logits(emb, th, softcap=cap),
                     rcm.embed_logits({"table": table}, jh, softcap=cap))
    ids = r.integers(0, 50, (3, 5))
    np.testing.assert_array_equal(
        _np(tcm.embed_lookup(emb, torch.from_numpy(ids))),
        _np(rcm.embed_lookup({"table": table}, jnp.asarray(ids))))
    CLOSE[dtype](tcm.swiglu(tx, tx * 0.5), rcm.swiglu(jx, jx * 0.5))
    CLOSE[dtype](tcm.geglu(tx, tx * 0.5), rcm.geglu(jx, jx * 0.5))


def test_rope_is_split_half():
    """The first half pairs with the second half (not interleaved)."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = tcm.apply_rope(x, torch.tensor([[1]]), 10000.0)
    assert out[..., 4].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[..., 1].item() == 0.0


def test_dense_init_is_seeded_truncated_fan_in():
    g = torch.Generator().manual_seed(3)
    w = tcm.dense_init((256, 4, 8), (0,), generator=g)
    again = tcm.dense_init((256, 4, 8), (0,),
                           generator=torch.Generator().manual_seed(3))
    assert torch.equal(w, again)
    assert w.abs().max().item() <= 2.0 / 16 + 1e-7
    assert 0.8 / 16 < w.std().item() < 1.0 / 16


# -------------------------------------------------------------------- mlp
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp_parity(dtype, activation):
    rp = rmlp.gated_init(jax.random.PRNGKey(1), 32, 64)
    tp = load(tmlp.GatedMLP(32, 64, device="meta"), rp)
    x = _rng(1).normal(0, 1, (2, 5, 32))
    jx, tx = pair(x, dtype)
    CLOSE[dtype](tmlp.gated_apply(tp, tx, activation=activation),
                 rmlp.gated_apply(rp, jx, activation=activation))
    rp = rmlp.plain_init(jax.random.PRNGKey(2), 32, 64)
    rp = jax.tree.map(lambda a: a + 0.1, rp)          # non-zero biases
    tp = load(tmlp.PlainMLP(32, 64, device="meta"), rp)
    CLOSE[dtype](tmlp.plain_apply(tp, tx), rmlp.plain_apply(rp, jx))


# -------------------------------------------------------------- attention
ATTN_CASES = {
    "gqa": dict(),
    "bias": dict(use_bias=True),
    "softcap_scale": dict(logit_softcap=50.0, query_scale=0.3),
    "mha": dict(n_kv_heads=4),
}


def _attn(case, seed=0):
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              rope_theta=10000.0)
    kw.update(ATTN_CASES[case])
    rcfg, tcfg = rattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    rp = rattn.init(jax.random.PRNGKey(seed), rcfg)
    if rcfg.use_bias:          # zero at init: make the bias count
        rp = {k: (v + 0.2 if k.startswith("b") else v)
              for k, v in rp.items()}
    return rcfg, tcfg, rp, load(tattn.Attention(tcfg, device="meta"), rp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("window,q_chunk", [(None, None), (5, None),
                                            (None, 4), (5, 4)])
def test_attend_train_parity(dtype, case, window, q_chunk):
    rcfg, tcfg, rp, tp = _attn(case)
    s = 12
    x = _rng(2).normal(0, 1, (2, s, 32))
    jx, tx = pair(x, dtype)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    got = tattn.attend_train(tp, tcfg, tx, torch.from_numpy(pos.copy()),
                             window=window, q_chunk=q_chunk)
    want = rattn.attend_train(rp, rcfg, jx, jnp.asarray(pos), window=window,
                              q_chunk=q_chunk)
    CLOSE[dtype](got, want)


def test_chunked_attention_keeps_the_divisibility_assertion():
    _, tcfg, _, tp = _attn("gqa")
    x = torch.zeros(1, 10, 32)
    with pytest.raises(AssertionError):
        tattn.attend_train(tp, tcfg, x, torch.zeros(1, 10, dtype=torch.int32),
                           q_chunk=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
def test_attend_prefill_decode_parity_past_max_len(dtype, window):
    """Prefill 10 tokens into a 16-row cache, then decode 9 more: the last
    three writes start past the buffer, where JAX clamps the start to the
    last row and the port must do the same."""
    rcfg, tcfg, rp, tp = _attn("bias")
    r = _rng(3)
    s, max_len = 10, 16
    x = r.normal(0, 1, (2, s, 32))
    jx, tx = pair(x, dtype)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    rcache = rattn.init_cache(rcfg, 2, max_len)
    tcache = tattn.init_cache(tcfg, 2, max_len)
    rout, rcache = rattn.attend_prefill(rp, rcfg, jx, jnp.asarray(pos),
                                        rcache, window=window)
    tout, tcache = tattn.attend_prefill(tp, tcfg, tx, torch.from_numpy(pos),
                                        tcache, window=window)
    CLOSE[dtype](tout, rout)
    cache_tol = CACHE_TOL if dtype == "float32" else BF16_TOL
    for key in ("k", "v"):
        close_f32(tcache[key], rcache[key], cache_tol)
    for step in range(9):
        # both decode from the same cache bits: carry the reference's
        tcache = {k: torch.from_numpy(np.array(rcache[k].astype(jnp.float32)))
                  .to(torch.bfloat16) for k in ("k", "v")}
        xd = r.normal(0, 1, (2, 1, 32))
        jd, td = pair(xd, dtype)
        rout, rcache = rattn.attend_decode(rp, rcfg, jd, rcache, s + step,
                                           window=window)
        tout, tcache = tattn.attend_decode(tp, tcfg, td, tcache, s + step,
                                           window=window)
        CLOSE[dtype](tout, rout)
        for key in ("k", "v"):
            close_f32(tcache[key], rcache[key], cache_tol)
    # the clamped writes landed on the last row, as the reference's did
    assert np.abs(_np(tcache["k"][:, -1])).max() > 0


def test_attend_prefill_refuses_an_overlong_prompt():
    _, tcfg, _, tp = _attn("gqa")
    with pytest.raises(ValueError):
        tattn.attend_prefill(tp, tcfg, torch.zeros(1, 9, 32),
                             torch.zeros(1, 9, dtype=torch.int32),
                             tattn.init_cache(tcfg, 1, 8))


@pytest.mark.parametrize("masked", [False, True])
def test_attend_cross_parity(masked):
    rcfg, tcfg, rp, tp = _attn("bias")
    r = _rng(4)
    x, feats = r.normal(0, 1, (2, 5, 32)), r.normal(0, 1, (2, 9, 32))
    jx, tx = pair(x, "float32")
    jf, tf = pair(feats, "float32")
    mask = r.random((2, 9)) > 0.3 if masked else None
    got = tattn.attend_cross(tp, tcfg, tx, tf, None if mask is None
                             else torch.from_numpy(mask))
    want = rattn.attend_cross(rp, rcfg, jx, jf, None if mask is None
                              else jnp.asarray(mask))
    close_f32(got, want)


# -------------------------------------------------------------------- moe
def _moe(capacity_factor=2.5, seed=0, e=4, k=2):
    kw = dict(d_model=16, d_ff=24, n_experts=e, top_k=k,
              capacity_factor=capacity_factor)
    rcfg, tcfg = rmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    rp = rmoe.init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, tcfg, rp, load(tmoe.MoE(tcfg, device="meta"), rp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 24, 512])
def test_moe_parity(dtype, s):
    rcfg, tcfg, rp, tp = _moe(capacity_factor=1.25)
    x = _rng(5).normal(0, 1, (2, s, 16))
    jx, tx = pair(x, dtype)
    out, aux = tmoe.apply(tp, tcfg, tx)
    rout, raux = rmoe.apply(rp, rcfg, jx)
    CLOSE[dtype](out, rout)
    close_f32(aux, raux)


def test_moe_exact_tie_picks_the_reference_expert():
    """A zero router makes every expert's probability 1/E: one exact tie
    across all experts, broken to the lowest indices by lax.top_k."""
    rcfg, tcfg, rp, tp = _moe(e=8, k=2)
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    tp.router = torch.nn.Parameter(torch.zeros(16, 8), requires_grad=False)
    x = _rng(6).normal(0, 1, (1, 8, 16))
    probs = torch.softmax(torch.zeros(1, 8, 8), -1)
    idx, gates = tmoe.route(probs, 2)
    assert idx.flatten().tolist() == [0, 1] * 8
    jx, tx = pair(x, "float32")
    close_f32(tmoe.apply(tp, tcfg, tx)[0], rmoe.apply(rp, rcfg, jx)[0])
    # a three-way tie: experts 2, 5 and 6 share floor(16·p) = 4; the k
    # order is descending, the lower index first among equals
    p = torch.tensor([[[0.02, 0.03, 0.30, 0.05, 0.01, 0.31, 0.28, 0.00]]])
    idx, _ = tmoe.route(p, 3)
    _, ridx = jax.lax.top_k(jnp.floor(jnp.asarray(p.numpy()) * 16.0), 3)
    assert idx.flatten().tolist() == np.asarray(ridx).flatten().tolist() \
        == [2, 5, 6]


def test_moe_capacity_overflow_drops_the_same_tokens():
    """One expert's router column dominates: far more tokens pick it than
    its capacity holds, and both packages drop the same ones."""
    rcfg, tcfg, rp, tp = _moe(capacity_factor=0.5, e=4, k=1)
    router = np.array(rp["router"])
    router[:, 1] += 40.0 * np.sign(router[:, 1])
    rp = dict(rp, router=jnp.asarray(router))
    load(tp, {"router": router})
    x = np.abs(_rng(7).normal(0, 1, (2, 40, 16)))
    jx, tx = pair(x, "float32")
    out, _ = tmoe.apply(tp, tcfg, tx)
    rout, _ = rmoe.apply(rp, rcfg, jx)
    close_f32(out, rout)
    dropped = (out.abs().amax(-1) == 0)
    np.testing.assert_array_equal(dropped.numpy(),
                                  np.abs(np.asarray(rout)).max(-1) == 0)
    cap = tmoe.group_capacity(tcfg, 40)
    assert dropped.sum().item() >= 2 * (40 - 4 * cap) > 0


# ------------------------------------------------------------------ models
def _configs(arch, dtype):
    rc, tc = rconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    if dtype == "float32":
        rc = dataclasses.replace(rc, compute_dtype="float32")
        tc = dataclasses.replace(tc, compute_dtype="float32")
    return rc, tc


def _batch(cfg, b, s, seed=2):
    r = _rng(seed)
    batch = {"tokens": r.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.n_image_tokens:
        batch["extra_embeds"] = r.normal(
            0, 1, (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch, dtype):
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("extra_embeds",):
        if k in batch:
            rb[k], tb[k] = pair(batch[k], dtype)
    return rb, tb


def _layerwise(rc, tc, rparams, tparams, rb, tb):
    """Each layer of both packages from the reference's hidden state (the
    reference's own ``_attn_train`` and ``_ffn``), held to the bf16 bar;
    returns the layers' count."""
    h = rtf._embed_in(rparams, rc, rb["tokens"], rb.get("extra_embeds"))
    b, s, _ = h.shape
    rpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    tpos = torch.arange(s, dtype=torch.int32).expand(b, s)
    g, windows = rtf.group_size(rc), rtf._group_windows(rc)
    for i, layer in enumerate(tparams.layers):
        p = jax.tree.map(lambda a: a[i // g], rparams["layers"][i % g])
        w = windows[i % g]
        rh, _ = rtf._ffn(rc, p, rtf._attn_train(rc, p, h, rpos, w))
        th = torch.from_numpy(_np(h).copy()).to(torch.bfloat16)
        th, _ = ttf._ffn(tc, layer, ttf._attn_train(tc, layer, th, tpos, w))
        close_bf16(th, rh)
        h = rh
    return len(tparams.layers)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_model_parity(arch, dtype):
    """forward_train, prefill and decode_step of the port against the
    reference on the reference's weights; then the port's own prefill and
    decode against its forward_train.

    MoE configs at bf16 are held layer by layer from the reference's
    hidden state instead of end to end: a token whose router probability
    sits within the bf16 noise of the residual stream from a 1/16 step of
    the quantized select goes to another expert in one package than in
    the other (both legitimately), and its logits then differ by far more
    than 5e-2.  Their float32 case is held end to end."""
    rc, tc = _configs(arch, dtype)
    rm, tm = rget_model(rc), tget_model(tc)
    rparams = rm.init_params(jax.random.PRNGKey(0))
    tparams = interop.model_params(rparams, tc, device=CPU)
    b, s, max_len = 2, 32, 40
    batch = _batch(tc, b, s)
    rb, tb = _both(batch, dtype)
    end_to_end = not (tc.n_experts and dtype == "bfloat16")
    close = CLOSE[dtype] if end_to_end else (lambda got, want: None)
    if not end_to_end:
        assert _layerwise(rc, tc, rparams, tparams, rb, tb) == tc.n_layers

    rfull, raux = jax.jit(rm.forward_train)(rparams, rb)
    tfull, taux = tm.forward_train(tparams, tb)
    close(tfull, rfull)
    if end_to_end:
        close_f32(taux, raux)

    pre = dict(batch, tokens=batch["tokens"][:, :s - 1])
    rpre, tpre = _both(pre, dtype)
    rlog, rstate = jax.jit(rm.prefill, static_argnums=2)(rparams, rpre,
                                                         max_len)
    tlog, tstate = tm.prefill(tm.compute_params(tparams), tpre, max_len)
    close(tlog, rlog)
    carried = interop.decode_state(rstate, tc, device=CPU)
    if end_to_end:
        for key in ("k", "v"):
            close_f32(tstate[key], carried[key],
                      CACHE_TOL if dtype == "float32" else BF16_TOL)
    assert tstate["len"] == carried["len"] == int(rstate["len"])

    tok = batch["tokens"][:, s - 1:]
    rdec, _ = jax.jit(rm.decode_step)(rparams, jnp.asarray(tok), rstate)
    tdec, tnext = tm.decode_step(tparams, torch.from_numpy(tok), carried)
    close(tdec, rdec)
    assert tnext["len"] == carried["len"] + 1

    # the port's own consistency: prefill + decode against forward_train
    own, _ = tm.decode_step(tparams, torch.from_numpy(tok), tstate)
    close_bf16(own[:, 0], tfull[:, -1])
    close_bf16(tlog[:, 0], tfull[:, -2])
    for out in (tfull, tlog, tdec, own):
        assert bool(torch.isfinite(out.float()).all())


def test_compute_copy_casts_weights_once_and_keeps_float32_reads():
    cfg = tconfigs.get_smoke_config("dbrx-132b")
    model = tget_model(cfg)
    params = model.init_params(0, device=CPU)
    copy = model.compute_params(params)
    for (name, p), (_, c) in zip(params.named_parameters(),
                                 copy.named_parameters()):
        f32 = name.endswith("router") or ".ln" in name \
            or name.startswith("final_norm")
        assert c.dtype == (torch.float32 if f32 else torch.bfloat16), name
        assert torch.equal(c, p.to(c.dtype))
    batch = {"tokens": torch.from_numpy(_batch(cfg, 2, 16)["tokens"])}
    a, _ = model.forward_train(params, batch)
    b, _ = model.forward_train(copy, batch)
    assert torch.equal(a, b)        # the same rounding, once
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    f32_params = tget_model(f32).init_params(0, device=CPU)
    assert tget_model(f32).compute_params(f32_params) is f32_params


def test_chunked_prefill_in_the_model(monkeypatch):
    """Q_CHUNK made small in both transformer modules: gemma2's chunked
    path, with its window, against the reference's."""
    monkeypatch.setattr(rtf, "Q_CHUNK", 8)
    monkeypatch.setattr(ttf, "Q_CHUNK", 8)
    rc, tc = _configs("gemma2-27b", "float32")
    rm, tm = rget_model(rc), tget_model(tc)
    rparams = rm.init_params(jax.random.PRNGKey(0))
    tparams = interop.model_params(rparams, tc, device=CPU)
    batch = _batch(tc, 1, 48)
    rb, tb = _both(batch, "float32")
    rlog, _ = jax.jit(rm.forward_train)(rparams, rb)
    tlog, _ = tm.forward_train(tparams, tb)
    close_f32(tlog, rlog)
    tpre, _ = tm.prefill(tparams, tb, 64)
    close_f32(tpre[:, 0], tlog[:, -1])
    monkeypatch.setattr(ttf, "Q_CHUNK", 2048)
    tone, _ = tm.forward_train(tparams, tb)
    close_f32(tone, tlog)


# --------------------------------------------------------------- structure
def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and not isinstance(tree[0], int):
        return tuple(_shape_tree(v) for v in tree)
    return tuple(tree.shape) if hasattr(tree, "shape") else tuple(tree)


def _congruent(specs, shapes):
    if isinstance(specs, dict):
        assert set(specs) == set(shapes), (set(specs), set(shapes))
        for k in specs:
            _congruent(specs[k], shapes[k])
    elif isinstance(shapes, tuple) and shapes and \
            isinstance(shapes[0], dict):
        assert len(specs) == len(shapes)
        for a, b in zip(specs, shapes):
            _congruent(a, b)
    else:
        assert len(specs) == len(shapes), (specs, shapes)


def _dtype_tree(tree):
    if isinstance(tree, dict):
        return {k: _dtype_tree(v) for k, v in tree.items() if k != "len"}
    return str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS + [
    "rwkv6-1.6b", "zamba2-7b", "whisper-base"])
def test_full_config_shapes_equal_the_reference(arch):
    """The published configs on the meta device: every parameter shape is
    the reference's ``abstract_params()`` leaf, the logical-axes tree is
    congruent and equal to the reference's, and the count is within 12%
    of ``param_count()``.  The decode state: transformers' (n_layers,
    batch, max_len, kv_heads, head_dim) K/V in layer order; the other
    families keep the reference's tree, every leaf's shape and dtype
    that of ``jax.eval_shape`` of its ``init_decode_state``."""
    tc = tconfigs.get_config(arch)
    tm = tget_model(tc)
    rm = rget_model(rconfigs.get_config(arch))
    meta = tm.abstract_params()
    assert all(p.device.type == "meta" for p in meta.parameters())
    shapes = tm.param_shapes(meta)
    assert shapes == _shape_tree(rm.abstract_params())
    _congruent(tm.param_specs(), shapes)
    assert tm.param_specs() == rm.param_specs()
    total = sum(p.numel() for p in meta.parameters())
    assert abs(total - tc.param_count()) / tc.param_count() < 0.12
    state = tm.init_decode_state(2, 16, device="meta")
    spec = tm.decode_state_specs()
    if tc.family in ("dense", "moe", "vlm"):
        assert state["k"].shape == (tc.n_layers, 2, 16, tc.n_kv_heads,
                                    tc.resolved_head_dim)
        assert len(spec["k"]) == state["k"].ndim
        return
    rstate = jax.eval_shape(lambda: rm.init_decode_state(2, 16))
    body = lambda t: {k: v for k, v in t.items() if k != "len"}
    assert _shape_tree(body(state)) == _shape_tree(body(rstate))
    assert _dtype_tree(state) == jax.tree.map(
        lambda a: np.dtype(a.dtype).name, body(rstate))
    assert all(t.device.type == "meta" for t in jax.tree.leaves(body(state)))
    _congruent(body(spec), _shape_tree(body(state)))
    assert spec == rm.decode_state_specs()


def test_configs_are_the_references():
    for arch in rconfigs.ARCHS:
        for get in ("get_config", "get_smoke_config"):
            r = getattr(rconfigs, get)(arch)
            t = getattr(tconfigs, get)(arch)
            assert dataclasses.asdict(r) == dataclasses.asdict(t)
            assert r.param_count() == t.param_count()
            assert r.active_param_count() == t.active_param_count()
            assert [s.name for s in rconfigs.shapes_for(r)] == \
                [s.name for s in tconfigs.shapes_for(t)]
    assert tconfigs.SHAPES.keys() == rconfigs.SHAPES.keys()


def test_input_specs_and_batch_tokens():
    cfg = tconfigs.get_config("llava-next-mistral-7b")
    tm = tget_model(cfg)
    specs = tm.input_specs(tconfigs.SHAPES["train_4k"])
    assert specs["tokens"].shape == (256, 4096 - 2880)
    assert specs["extra_embeds"].shape == (256, 2880, 4096)
    assert specs["labels"].shape == (256, 4096)
    dec = tm.input_specs(tconfigs.SHAPES["decode_32k"])
    assert dec["state"]["k"].device.type == "meta"
    assert tm.batch_tokens(tconfigs.SHAPES["decode_32k"]) == 128
    assert tm.batch_tokens(tconfigs.SHAPES["prefill_32k"]) == 32 * 32768


def test_entry_points_default_to_cuda():
    tm = tget_model(tconfigs.get_smoke_config("yi-6b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_params(0)
