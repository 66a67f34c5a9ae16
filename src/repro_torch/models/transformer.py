"""Decoder-only transformer LM (port of ``repro.models.transformer``):
dense (internlm2/yi/qwen1.5/mistral-llava), gemma2 (local/global + softcaps
+ sandwich norms), and MoE (dbrx/phi3.5-moe).  ``forward_train`` runs
under autograd, with the reference's remat choice per layer group
(``cfg.remat``); ``prefill`` and ``decode_step`` run without it.

The reference scans stacked layer trees; here the layers are an
``nn.ModuleList`` in layer order, and layer ``i`` runs with the window of
position ``i % g`` of the pattern (gemma2: local first).  ``param_shapes``
and ``param_specs`` give the reference's grouped tree (``layers`` a tuple
of ``g`` stacks with a leading ``n_groups`` axis), so shapes and logical
axes can be held against it.

Three execution paths share one layer body:
  forward_train : tokens -> logits (full causal), differentiable
  prefill       : tokens -> logits of the last position, KV cache
  decode_step   : 1 token + cache -> logits, cache (written in place)
VLM (llava) is this model with stub patch embeddings prepended to the
token embeddings.

Parameters are float32 masters and compute runs in ``cfg.compute_dtype``;
``compute_copy`` makes the compute-dtype copy of the weights the reference
casts at every product once, so a decode step reads bf16 weights.  The
train step casts inside autograd instead and passes the cast tensors as
a ``common.param_view`` of the model, which every function here reads as
it reads the module.  The KV cache is bf16 even when compute is float32,
as in the reference.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib

Q_CHUNK = 2048  # query chunking kicks in above this seq len (read per call)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _attn_cfg(cfg: ModelConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        use_bias=cfg.use_qkv_bias, logit_softcap=cfg.attn_softcap,
        query_scale=cfg.query_scale, seq_shard=cfg.attn_seq_shard)


def _moe_cfg(cfg: ModelConfig) -> moe_lib.MoEConfig:
    return moe_lib.MoEConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        activation=cfg.activation)


def _norm_module(cfg, device, dtype):
    cls = cm.RMSNorm if cfg.norm == "rmsnorm" else cm.LayerNorm
    return cls(cfg.d_model, device=device, dtype=dtype)


def _norm_specs(cfg):
    return (cm.rmsnorm_specs() if cfg.norm == "rmsnorm"
            else cm.layernorm_specs())


def _norm(cfg, p, x):
    return cm.rmsnorm(p, x) if cfg.norm == "rmsnorm" else cm.layernorm(p, x)


def group_size(cfg: ModelConfig) -> int:
    """Layers per pattern period: 2 for alternating local/global, else 1."""
    if cfg.layer_pattern == "local_global":
        assert cfg.n_layers % 2 == 0
        return 2
    return 1


def _group_windows(cfg: ModelConfig) -> tuple[int | None, ...]:
    if cfg.layer_pattern == "local_global":
        return (cfg.sliding_window, None)      # gemma2: local layer first
    return (None,)


def _layer_windows(cfg: ModelConfig) -> list[int | None]:
    windows = _group_windows(cfg)
    return [windows[i % len(windows)] for i in range(cfg.n_layers)]


# ----------------------------------------------------------------- params
class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = _norm_module(cfg, device, dtype)
        self.ln2 = _norm_module(cfg, device, dtype)
        self.attn = attn.Attention(_attn_cfg(cfg), **kw)
        if cfg.n_experts:
            self.moe = moe_lib.MoE(_moe_cfg(cfg), **kw)
        else:
            self.mlp = mlp_lib.GatedMLP(cfg.d_model, cfg.d_ff, **kw)
        if cfg.post_norms:
            self.ln1_post = _norm_module(cfg, device, dtype)
            self.ln2_post = _norm_module(cfg, device, dtype)


class Transformer(nn.Module):
    """The zoo's decoder: ``embed`` (tied), ``layers``, ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=None):
        super().__init__()
        dtype = dtype or torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = cm.Embedding(cfg.vocab_size, cfg.d_model,
                                  generator=generator, device=device,
                                  dtype=dtype)
        self.final_norm = _norm_module(cfg, device, dtype)
        self.layers = nn.ModuleList(
            Block(cfg, generator=generator, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))


def init_params(cfg: ModelConfig, generator=None, dtype=None, device=None):
    """Seeded random weights: ``generator`` is a ``torch.Generator`` on
    ``device`` or an int seed."""
    if not isinstance(generator, torch.Generator):
        seed = 0 if generator is None else int(generator)
        generator = torch.Generator(device=device).manual_seed(seed)
    return Transformer(cfg, generator=generator, device=device, dtype=dtype)


def abstract_params(cfg: ModelConfig):
    """The model on the meta device: shapes and dtypes, no storage."""
    return Transformer(cfg, device="meta")


def _module_tree(mod: nn.Module, leaf):
    tree = {n: leaf(p) for n, p in mod.named_parameters(recurse=False)}
    for n, child in mod.named_children():
        tree[n] = _module_tree(child, leaf)
    return tree


def param_shapes(params) -> dict:
    """The parameters' shapes as the reference's grouped tree: layer ``i``
    is slot ``i % g`` of group ``i // g``."""
    cfg = params.cfg
    g = group_size(cfg)
    n_groups = cfg.n_layers // g

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return (n_groups,) + tree

    shape = lambda p: tuple(p.shape)
    return {
        "embed": _module_tree(params.embed, shape),
        "final_norm": _module_tree(params.final_norm, shape),
        "layers": tuple(stacked(_module_tree(params.layers[j], shape))
                        for j in range(g)),
    }


def _layer_specs(cfg: ModelConfig):
    s = {"ln1": _norm_specs(cfg), "ln2": _norm_specs(cfg),
         "attn": attn.specs(_attn_cfg(cfg))}
    if cfg.n_experts:
        s["moe"] = moe_lib.specs(_moe_cfg(cfg))
    else:
        s["mlp"] = mlp_lib.gated_specs()
    if cfg.post_norms:
        s["ln1_post"] = _norm_specs(cfg)
        s["ln2_post"] = _norm_specs(cfg)
    return s


def param_specs(cfg: ModelConfig):
    g = group_size(cfg)
    layer = cm.add_layer_axis_to_specs(_layer_specs(cfg))
    return {
        "embed": cm.embed_specs(),
        "final_norm": _norm_specs(cfg),
        "layers": tuple(layer for _ in range(g)),
    }


def compute_copy(params):
    """The model with every weight the reference casts to the compute dtype
    at each product cast once.  Norm parameters and the MoE router, which
    the reference reads in float32, are shared with ``params``; with float32
    compute ``params`` itself is returned."""
    cfg = params.cfg
    dt = torch_dtype(cfg.compute_dtype)
    if all(p.dtype == dt for p in params.parameters()):
        return params
    out = Transformer(cfg, device="meta")
    for (_, dst), (_, src) in zip(out.named_modules(), params.named_modules()):
        for name, t in src.named_parameters(recurse=False):
            keep = (isinstance(src, (cm.RMSNorm, cm.LayerNorm))
                    or (isinstance(src, moe_lib.MoE) and name == "router"))
            setattr(dst, name, nn.Parameter(t if keep else t.to(dt),
                                            requires_grad=False))
    return out


# ----------------------------------------------------------------- bodies
def _ffn(cfg: ModelConfig, p, h):
    """Post-attention half of a block. Returns (h, aux)."""
    x = _norm(cfg, p.ln2, h)
    if cfg.n_experts:
        m, aux = moe_lib.apply(p.moe, _moe_cfg(cfg), x)
    else:
        m = mlp_lib.gated_apply(p.mlp, x, activation=cfg.activation)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.post_norms:
        m = _norm(cfg, p.ln2_post, m)
    return h + m, aux


def _attn_train(cfg: ModelConfig, p, h, positions, window):
    """Pre-FFN half of a block on the full sequence. Returns h."""
    a = attn.attend_train(p.attn, _attn_cfg(cfg), _norm(cfg, p.ln1, h),
                          positions, window=window,
                          q_chunk=_q_chunk(h.shape[1]))
    if cfg.post_norms:
        a = _norm(cfg, p.ln1_post, a)
    return h + a


def _embed_in(params, cfg: ModelConfig, tokens, extra_embeds):
    dt = torch_dtype(cfg.compute_dtype)
    h = cm.embed_lookup(params.embed, tokens.long()).to(dt)
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                             device=h.device)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(dt), h], dim=1)
    return h


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _q_chunk(s):
    return Q_CHUNK if s > Q_CHUNK else None


# ------------------------------------------------------------------- train
def _saves_dots(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of products with no batch dimension, recompute the rest.
    ``torch.einsum`` lowers a contraction with no batch dimension to a
    ``bmm`` of batch 1, so that is what is kept beside ``mm``/``addmm``;
    attention's and the experts' products (batched) are recomputed."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn(h)`` under the config's activation checkpointing: "none" keeps
    every activation, "full" keeps the group's input and recomputes the
    rest in the backward pass, "dots" keeps the products with no batch
    dimension as well."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _saves_dots))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def forward_train(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """tokens: (B, S_text) int; extra_embeds: (B, N, d) prepended (llava).
    Returns (logits: (B, S_total, vocab), aux_loss: scalar).  Layers run
    in groups of ``group_size(cfg)`` (gemma2: a local and a global layer),
    each group under ``_maybe_remat`` when autograd records (without it
    there is nothing to keep)."""
    h = _embed_in(params, cfg, tokens, extra_embeds)
    b, s, _ = h.shape
    positions = _positions(b, s, h.device)
    windows = _group_windows(cfg)
    layers = list(params.layers)
    records = torch.is_grad_enabled() and h.requires_grad
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def group_body(group, h):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for p, w in zip(group, windows):
            h, a = _ffn(cfg, p, _attn_train(cfg, p, h, positions, w))
            aux = aux + a
        return h, aux

    for i in range(0, len(layers), len(windows)):
        body = functools.partial(group_body, layers[i:i + len(windows)])
        h, a = (_maybe_remat(cfg, body) if records else body)(h)
        aux = aux + a
    h = _norm(cfg, params.final_norm, h)
    logits = cm.embed_logits(params.embed, h, softcap=cfg.final_softcap)
    return logits, aux


# ------------------------------------------------------------------ serving
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None):
    """``k``/``v``: (n_layers, batch, max_len, kv_heads, head_dim) in layer
    order; ``len``: the tokens already in the cache (a host int)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


def decode_state_specs(cfg: ModelConfig):
    layer = cm.add_layer_axis_to_specs(attn.cache_specs())
    return {"k": layer["k"], "v": layer["v"], "len": ()}


def _layer_cache(state, i):
    return {"k": state["k"][i], "v": state["v"][i]}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, max_len: int,
            extra_embeds=None, cache_dtype=torch.bfloat16):
    """Run the prompt, build the cache. Returns (logits, state)."""
    h = _embed_in(params, cfg, tokens, extra_embeds)
    b, s, _ = h.shape
    positions = _positions(b, s, h.device)
    acfg = _attn_cfg(cfg)
    state = init_decode_state(cfg, b, max_len, cache_dtype, h.device)
    for i, (p, w) in enumerate(zip(params.layers, _layer_windows(cfg))):
        a, _ = attn.attend_prefill(
            p.attn, acfg, _norm(cfg, p.ln1, h), positions,
            _layer_cache(state, i), window=w, q_chunk=_q_chunk(s))
        if cfg.post_norms:
            a = _norm(cfg, p.ln1_post, a)
        h, _ = _ffn(cfg, p, h + a)
    h = _norm(cfg, params.final_norm, h)
    logits = cm.embed_logits(params.embed, h[:, -1:],
                             softcap=cfg.final_softcap)
    state["len"] = s
    return logits, state


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, state):
    """token: (B, 1) int. Writes the new K/V into ``state``'s cache in
    place and returns (logits (B, 1, V), the state with ``len`` + 1)."""
    h = _embed_in(params, cfg, token, None)
    cache_len = int(state["len"])
    acfg = _attn_cfg(cfg)
    for i, (p, w) in enumerate(zip(params.layers, _layer_windows(cfg))):
        a, _ = attn.attend_decode(p.attn, acfg, _norm(cfg, p.ln1, h),
                                  _layer_cache(state, i), cache_len,
                                  window=w)
        if cfg.post_norms:
            a = _norm(cfg, p.ln1_post, a)
        h, _ = _ffn(cfg, p, h + a)
    h = _norm(cfg, params.final_norm, h)
    logits = cm.embed_logits(params.embed, h, softcap=cfg.final_softcap)
    return logits, {"k": state["k"], "v": state["v"], "len": cache_len + 1}
