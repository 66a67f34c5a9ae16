"""The port's train step against the reference's, on the CPU.

One step of each family's smoke config (internlm2 dense, gemma2
softcaps and local/global, phi3.5 MoE, llava VLM, rwkv6, zamba2 and
whisper's encoder-decoder), both packages
started from the reference's train state carried over with
``interop.train_state``, on the same numpy batch.  Bars:

* float32 compute: loss, ce, aux, z and grad_norm within 1e-5 relative;
  mu after the step (0.1 · the clipped gradient) within 1e-5 · max|mu|
  of each tensor (float32 sums in other orders; ``RESIDUAL_GRADS``, whose
  gradients are rounding residuals, within 1e-5 of the model's largest
  mu); the updated parameters
  within 2·lr + 1e-5 · max|p|: Adam's first step moves each weight by
  lr · g / (|g| + eps), so an element whose gradient is near 0 and
  differs in its last bits between the packages can move ±lr the other
  way;
* the configs' own bf16 compute: the loss within the reference's 5e-2
  bar (``tests/test_arch_smoke.py``).  MoE configs are also held layer
  by layer from the reference's hidden state, as in
  ``tests/test_torch_models.py``: a router probability within the bf16
  noise of a 1/16 step picks another expert in each package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rconfigs
from repro.models import get_model as rget_model
from repro.models import transformer as rtf
from repro.train import TrainConfig as RTrainConfig
from repro.train import cross_entropy as rcross_entropy
from repro.train import init_train_state as rinit
from repro.train import make_eval_step as rmake_eval
from repro.train import make_train_step as rmake_step
from repro.train import train_state_specs as rspecs
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import get_model as tget_model
from repro_torch.models import transformer as ttf
from repro_torch.train import (TrainConfig, abstract_train_state,
                               cross_entropy, init_train_state,
                               make_eval_step, make_train_step,
                               train_state_specs)
from repro_torch.train.train_step import _loss_fn

torch.set_num_threads(1)

TRANSFORMER_ARCHS = ["internlm2-1.8b", "gemma2-27b", "phi3.5-moe-42b-a6.6b",
                     "llava-next-mistral-7b"]
FAMILY_ARCHS = ["rwkv6-1.6b", "zamba2-7b", "whisper-base"]
ARCHS = TRANSFORMER_ARCHS + FAMILY_ARCHS
# the recurrent families' chunk: one sub-block of chunked_gla (whose
# off-diagonal pairs and backward tests/test_torch_gla.py holds), two
# chunks of the 32-token batch; it halves the reference's compile
FAMILY_CHUNK = 16
F32 = 1e-5
BF16 = 5e-2
# leaves whose gradient is a float32 residual, their mu held to 1e-5 of the
# model's largest mu rather than their own: an attention key bias's
# gradient is zero in exact arithmetic (a softmax is invariant to a shift
# of one query's logits), so both packages hold rounding noise there
# (whisper, ≈ 1e-9 of the largest); Mamba2's decay parameters a_log and
# dt_bias sum cancelling terms over positions through exp(cumulative
# log-decay) factors, whose float32 cumsums the two packages associate in
# other orders (2-15% of the largest)
RESIDUAL_GRADS = ("bk", "a_log", "dt_bias")


def _configs(arch, dtype, **kw):
    if dtype == "float32":
        kw["compute_dtype"] = "float32"
    if arch in FAMILY_ARCHS:
        kw.setdefault("ssm_chunk", FAMILY_CHUNK)
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **kw))


def _batch(cfg, b=2, s=32, seed=1, ones=False):
    """Tokens, labels and mask (llava: image embeddings before the text;
    whisper: 48 frames and the tokens as the decoder's)."""
    r = np.random.default_rng(seed)
    st = s + cfg.n_image_tokens
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab_size, (b, st)).astype(np.int32),
             "loss_mask": (np.ones((b, st)) if ones
                           else r.random((b, st)) > 0.2).astype(np.float32)}
    if cfg.n_image_tokens:
        batch["extra_embeds"] = r.normal(
            0, 1, (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["dec_tokens"] = batch.pop("tokens")
        batch["frames"] = r.normal(0, 1, (b, 48, cfg.d_model)).astype(
            np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()})


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _start(arch, dtype, **kw):
    rc, tc = _configs(arch, dtype, **kw)
    rm, tm = rget_model(rc), tget_model(tc)
    rs = rinit(rm, jax.random.PRNGKey(0))
    return rc, tc, rm, tm, rs, interop.train_state(rs, tc, device="cpu")


def _ref_named(tree, cfg):
    """A reference parameter-shaped tree as {port parameter name: array}."""
    return {n: p.detach() for n, p in
            interop.model_params(tree, cfg, device="cpu").named_parameters()}


@pytest.mark.parametrize("arch, dtype", [
    (a, d) for a in TRANSFORMER_ARCHS for d in ("float32", "bfloat16")] + [
    (a, "float32") for a in FAMILY_ARCHS])
def test_train_step_matches_the_reference(arch, dtype):
    rc, tc, rm, tm, rs, ts = _start(arch, dtype)
    rb, tb = _both(_batch(tc))
    rs2, rmet = jax.jit(rmake_step(rm, RTrainConfig()))(rs, rb)
    ts2, tmet = make_train_step(tm, TrainConfig())(ts, tb)
    assert set(tmet) == set(rmet)
    assert int(ts2["step"]) == int(rs2["step"]) == 1
    assert int(ts2["opt"]["count"]) == 1
    assert float(tmet["lr"]) == float(rmet["lr"])
    if dtype == "bfloat16":
        assert _rel(tmet["loss"], rmet["loss"]) <= BF16
        if tc.n_experts:
            assert _layerwise(rc, tc, tm, rs["params"], rb) == tc.n_layers
        return
    for k in ("loss", "ce", "aux", "z", "grad_norm"):
        assert _rel(tmet[k], rmet[k]) <= F32, k
    lr = float(rmet["lr"])
    want_p = _ref_named(rs2["params"], tc)
    for n, p in ts2["params"].named_parameters():
        err = np.abs(_np(p) - _np(want_p[n])).max()
        assert err <= 2 * lr + F32 * np.abs(_np(want_p[n])).max(), n
    want_mu = _ref_named(rs2["opt"]["mu"], tc)
    top = max(np.abs(_np(m)).max() for m in want_mu.values())
    for n, mu in ts2["opt"]["mu"].items():
        if n.rpartition(".")[2] in RESIDUAL_GRADS:
            err = np.abs(_np(mu) - _np(want_mu[n])).max()
            assert err <= F32 * top, n
        else:
            assert _rel(mu, want_mu[n]) <= F32, n


def _layerwise(rc, tc, tm, rparams, rb):
    """Each layer of both packages from the reference's hidden state, with
    the reference's start parameters cast to bf16 as ``_loss_fn`` casts
    them (the port reads them through ``param_view``), held to the bf16
    bar; returns the layers' count."""
    cast = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rparams)
    view = tm.param_view({n: p.to(torch.bfloat16) for n, p in
                          _ref_named(rparams, tc).items()})
    h = rtf._embed_in(cast, rc, rb["tokens"], rb.get("extra_embeds"))
    b, s, _ = h.shape
    rpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    tpos = torch.arange(s, dtype=torch.int32).expand(b, s)
    g, windows = rtf.group_size(rc), rtf._group_windows(rc)
    for i, layer in enumerate(view.layers):
        p = jax.tree.map(lambda a: a[i // g], cast["layers"][i % g])
        w = windows[i % g]
        rh, _ = rtf._ffn(rc, p, rtf._attn_train(rc, p, h, rpos, w))
        th = torch.from_numpy(_np(h).copy()).to(torch.bfloat16)
        th, _ = ttf._ffn(tc, layer, ttf._attn_train(tc, layer, th, tpos, w))
        assert _rel(th, rh) <= BF16, i
        h = rh
    return len(view.layers)


def _loss_and_grads(tm, params, batch, tc=TrainConfig()):
    names, masters = zip(*params.named_parameters())
    leaves = [p.detach().requires_grad_(True) for p in masters]
    loss, _ = _loss_fn(tm, tc, dict(zip(names, leaves)), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_bit_equal_gradients(arch):
    """none / full / dots recompute the same float32 ops on the CPU: the
    loss and every gradient are bit-equal."""
    out = {}
    for remat in ("none", "full", "dots"):
        _, tc = _configs(arch, "bfloat16", remat=remat)
        tm = tget_model(tc)
        params = tm.init_params(0, device="cpu")
        out[remat] = _loss_and_grads(tm, params, _both(_batch(tc))[1])
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out["none"][1]))


class _CountProducts(TorchDispatchMode):
    """Counts the ``bmm`` calls (every einsum product here) made while
    active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.bmm.default
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_what_its_policy_drops():
    """The products the backward pass runs: "none" only the gradients',
    "dots" those plus attention's two batched products per layer (the
    projections with no batch dimension are kept), "full" every product of
    every layer again; an unknown policy raises."""
    ran = {}
    for remat in ("none", "dots", "full"):
        _, tc = _configs("internlm2-1.8b", "float32", remat=remat)
        tm = tget_model(tc)
        params = tm.init_params(0, device="cpu")
        names, masters = zip(*params.named_parameters())
        leaves = [p.detach().requires_grad_(True) for p in masters]
        loss, _ = _loss_fn(tm, TrainConfig(), dict(zip(names, leaves)),
                           _both(_batch(tc))[1])
        with _CountProducts() as count:
            torch.autograd.grad(loss, leaves)
        ran[remat] = count.n
    assert ran["dots"] - ran["none"] == 2 * tc.n_layers
    # q, k, v; logits, values; out; gate, up: the recomputation stops once
    # the last saved tensor is rebuilt, before the layer's down projection
    assert ran["full"] - ran["none"] == 8 * tc.n_layers
    _, tc = _configs("internlm2-1.8b", "float32", remat="most")
    tm = tget_model(tc)
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads(tm, tm.init_params(0, device="cpu"),
                        _both(_batch(tc))[1])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "phi3.5-moe-42b-a6.6b"])
def test_microbatches_match_the_reference_and_one_batch(arch):
    """Two microbatches against the reference's two (float32 bars), and
    against one batch of the port with the MoE aux loss off (the Switch
    aux loss is a product of two means over the batch, so the halves'
    mean of it is not the whole batch's, in either package) and an
    all-ones mask (so the halves' mean of the masked means is the whole
    batch's): float32 sums in other orders, the same bars."""
    rc, tc, rm, tm, rs, ts = _start(arch, "float32")
    rb, tb = _both(_batch(tc, b=4, ones=True))
    rs2, rmet = jax.jit(rmake_step(rm, RTrainConfig(microbatches=2)))(rs, rb)
    ts2, tmet = make_train_step(tm, TrainConfig(microbatches=2))(ts, tb)
    assert set(tmet) == set(rmet) == {"loss", "grad_norm", "lr"}
    for k in ("loss", "grad_norm"):
        assert _rel(tmet[k], rmet[k]) <= F32, k
    want_mu = _ref_named(rs2["opt"]["mu"], tc)
    top = max(np.abs(_np(m)).max() for m in want_mu.values())
    for n, mu in ts2["opt"]["mu"].items():
        if n.rpartition(".")[2] in RESIDUAL_GRADS:
            err = np.abs(_np(mu) - _np(want_mu[n])).max()
            assert err <= F32 * top, n
        else:
            assert _rel(mu, want_mu[n]) <= F32, n
    two = interop.train_state(rs, tc, device="cpu")
    ts2, tmet = make_train_step(tm, TrainConfig(microbatches=2,
                                                aux_loss_weight=0.0))(two, tb)
    one = interop.train_state(rs, tc, device="cpu")
    one2, omet = make_train_step(tm, TrainConfig(aux_loss_weight=0.0))(one,
                                                                       tb)
    for k in ("loss", "grad_norm"):
        assert _rel(tmet[k], omet[k]) <= F32, k
    for n, mu in ts2["opt"]["mu"].items():
        assert _rel(mu, one2["opt"]["mu"][n]) <= F32, n


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "phi3.5-moe-42b-a6.6b"])
def test_eval_step_matches_the_reference(arch):
    rc, tc, rm, tm, rs, ts = _start(arch, "float32")
    rb, tb = _both(_batch(tc))
    want = jax.jit(rmake_eval(rm, RTrainConfig()))(rs["params"], rb)
    got = make_eval_step(tm, TrainConfig())(ts["params"], tb)
    assert set(got) == set(want) == {"loss", "ce", "aux", "z"}
    for k in got:
        assert not got[k].requires_grad
        assert _rel(got[k], want[k]) <= F32, k


@pytest.mark.parametrize("masked", ["random", "none", "empty"])
def test_cross_entropy_with_a_mask_matches_the_reference(masked):
    r = np.random.default_rng(3)
    logits = r.normal(0, 4, (3, 7, 50)).astype(np.float32)
    labels = r.integers(0, 50, (3, 7)).astype(np.int32)
    mask = {"random": r.random((3, 7)) > 0.4, "none": np.ones((3, 7)),
            "empty": np.zeros((3, 7))}[masked].astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = cross_entropy(torch.from_numpy(logits).to(dt),
                            torch.from_numpy(labels), torch.from_numpy(mask))
        want = rcross_entropy(jnp.asarray(logits).astype(jdt),
                              jnp.asarray(labels), jnp.asarray(mask))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(float(g), float(w), rtol=F32,
                                       atol=1e-6)
    if masked == "empty":
        assert float(got[0]) == 0.0 and float(got[1]) == 0.0


def test_moe_gradient_reaches_the_router_through_gates_and_aux():
    """The router's gradient comes from the exact gate values and the aux
    loss (the floor(16·p) selection has none): it is non-zero without the
    aux term, and the aux term changes it."""
    _, tc = _configs("phi3.5-moe-42b-a6.6b", "float32")
    tm = tget_model(tc)
    params = tm.init_params(0, device="cpu")
    batch = _both(_batch(tc))[1]
    names = [n for n, _ in params.named_parameters()]
    router = names.index("layers.0.moe.router")
    _, g_aux = _loss_and_grads(tm, params, batch)
    _, g_no = _loss_and_grads(tm, params, batch,
                              TrainConfig(aux_loss_weight=0.0))
    assert float(g_no[router].abs().max()) > 0
    assert not torch.equal(g_aux[router], g_no[router])
    assert all(bool(torch.isfinite(g).all()) for g in g_aux)


def test_train_states_init_abstract_and_specs():
    _, tc = _configs("gemma2-27b", "bfloat16")
    tm = tget_model(tc)
    a = init_train_state(tm, 5, device="cpu")
    b = init_train_state(tm, torch.Generator().manual_seed(5), device="cpu")
    meta = abstract_train_state(tm)
    for (n, p), (_, q), (_, m) in zip(a["params"].named_parameters(),
                                      b["params"].named_parameters(),
                                      meta["params"].named_parameters()):
        assert torch.equal(p, q), n
        assert p.dtype == torch.float32 and m.device.type == "meta"
        assert m.shape == p.shape and a["opt"]["mu"][n].shape == p.shape
        assert not bool(a["opt"]["nu"][n].any())
    assert meta["step"].device.type == "meta"
    assert a["step"].dtype == a["opt"]["count"].dtype == torch.int32
    rc, _ = _configs("gemma2-27b", "bfloat16")
    assert train_state_specs(tm) == rspecs(rget_model(rc))
