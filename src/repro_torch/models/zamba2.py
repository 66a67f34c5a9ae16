"""Zamba2-7B hybrid (port of ``repro.models.zamba2``; arXiv:2411.15242):
a Mamba2 backbone and two alternating *shared* attention blocks.

``n_layers`` Mamba2 blocks in ``n_groups`` groups of ``attn_every`` plus a
tail of the rest (zamba2-7b: 13 groups of 6 and a tail of 3).  Before
each group, shared block ``g % n_shared_blocks`` runs on
concat(hidden, initial embedding) at width 2·d_model, and its output,
projected back to d_model, joins the residual stream.  The reference's
simplifications are kept (no per-application LoRA on the shared
weights).

Modules: ``blocks`` is a list of groups, each a list of ``attn_every``
Mamba layers; ``tail`` (when ``n_layers % attn_every``) a list;
``shared`` a list of ``n_shared_blocks``.  ``param_shapes`` gives the
reference's stacked tree ((n_groups, attn_every), (tail,),
(n_shared_blocks,) leading axes).  The decode state is the reference's
tree: the Mamba states stacked the same way, one K/V cache per group
(``shared_kv``, bf16), ``len`` a host int; ``decode_step`` writes it in
place.  The shared attention takes its RoPE positions and decode mask
from the pooled ``len``, as in the reference.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mamba2
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import transformer
from repro_torch.models.transformer import torch_dtype
from repro_torch.sharding.rules import constrain, constrain_state


def _m2cfg(cfg: ModelConfig) -> mamba2.Mamba2Config:
    return mamba2.Mamba2Config(
        d_model=cfg.d_model, d_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
        conv_width=cfg.ssm_conv_width, chunk=cfg.ssm_chunk)


def _shared_attn_cfg(cfg: ModelConfig) -> attn.AttnConfig:
    d2 = 2 * cfg.d_model
    return attn.AttnConfig(
        d_model=d2, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=d2 // cfg.n_heads, rope_theta=cfg.rope_theta)


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def tail_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers % cfg.attn_every


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.ln = cm.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mamba = mamba2.init(_m2cfg(cfg), generator=generator,
                                 device=device, dtype=dtype)


class SharedMLP(nn.Module):
    """The shared block's SwiGLU: 2·d_model in, d_model out."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, d2 = cfg.d_model, 2 * cfg.d_model
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.w_gate = cm.dense_init((d2, cfg.d_ff), (0,), **kw)
        self.w_up = cm.dense_init((d2, cfg.d_ff), (0,), **kw)
        self.w_down = cm.dense_init((cfg.d_ff, d), (0,), **kw)


class SharedBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, d2 = cfg.d_model, 2 * cfg.d_model
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln_attn = cm.RMSNorm(d2, device=device, dtype=dtype)
        self.attn = attn.Attention(_shared_attn_cfg(cfg), **kw)
        self.attn_out = cm.dense_init((d2, d), (0,), **kw)
        self.ln_mlp = cm.RMSNorm(d2, device=device, dtype=dtype)
        self.mlp = SharedMLP(cfg, **kw)


class Zamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=None):
        super().__init__()
        dtype = dtype or torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        layer = lambda: MambaLayer(cfg, **kw)
        self.embed = cm.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(
            nn.ModuleList(layer() for _ in range(cfg.attn_every))
            for _ in range(n_groups(cfg)))
        self.shared = nn.ModuleList(SharedBlock(cfg, **kw)
                                    for _ in range(cfg.n_shared_blocks))
        self.final_norm = cm.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        if tail_layers(cfg):
            self.tail = nn.ModuleList(layer()
                                      for _ in range(tail_layers(cfg)))


def init_params(cfg: ModelConfig, generator=None, dtype=None, device=None):
    """Seeded random weights: ``generator`` is a ``torch.Generator`` on
    ``device`` or an int seed."""
    return Zamba2(cfg, generator=cm.make_generator(generator, device),
                  device=device, dtype=dtype)


def abstract_params(cfg: ModelConfig):
    return Zamba2(cfg, device="meta")


def param_shapes(params) -> dict:
    cfg = params.cfg
    out = {"embed": cm.shape_tree(params.embed),
           "blocks": cm.shape_tree(params.blocks[0][0],
                                   (n_groups(cfg), cfg.attn_every)),
           "shared": cm.shape_tree(params.shared[0], (len(params.shared),)),
           "final_norm": cm.shape_tree(params.final_norm)}
    if tail_layers(cfg):
        out["tail"] = cm.shape_tree(params.tail[0], (tail_layers(cfg),))
    return out


def _shared_block_specs(cfg: ModelConfig):
    return {
        "ln_attn": {"scale": ("embed",)},
        "attn": attn.specs(_shared_attn_cfg(cfg)),
        "attn_out": ("embed", "embed"),
        "ln_mlp": {"scale": ("embed",)},
        "mlp": {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")},
    }


def _prefixed(tree, axes):
    """Each spec of ``tree`` behind the logical axes ``axes``."""
    if isinstance(tree, dict):
        return {k: _prefixed(v, axes) for k, v in tree.items()}
    return axes + tuple(tree)


def param_specs(cfg: ModelConfig):
    block = {"ln": cm.rmsnorm_specs(), "mamba": mamba2.specs(_m2cfg(cfg))}
    s = {"embed": cm.embed_specs(),
         "blocks": _prefixed(block, ("layers", None)),
         "shared": cm.add_layer_axis_to_specs(_shared_block_specs(cfg)),
         "final_norm": cm.rmsnorm_specs()}
    if tail_layers(cfg):
        s["tail"] = cm.add_layer_axis_to_specs(block)
    return s


def compute_copy(params):
    """The weights cast to the compute dtype once; the RMSNorms, ``a_log``
    and ``dt_bias`` shared with ``params``."""
    return cm.compute_copy(params, torch_dtype(params.cfg.compute_dtype),
                           mamba2.keeps_float32)


# ------------------------------------------------------------------ shared
def _q_chunk(s):
    return transformer.Q_CHUNK if s > transformer.Q_CHUNK else None


def _shared_mlp(sp, h, emb0):
    x = cm.rmsnorm(sp.ln_mlp, torch.cat([h, emb0], dim=-1))
    return h + mlp_lib.gated_apply(sp.mlp, x)


def _attn_out(sp, h, a):
    return h + torch.einsum("bsd,de->bse", a, sp.attn_out.to(a.dtype))


def _apply_shared_train(sp, cfg: ModelConfig, emb0, positions, h):
    """One shared-block application on the full sequence."""
    h = constrain(h, "batch", None, None)
    xcat = torch.cat([h, emb0], dim=-1)
    a = attn.attend_train(sp.attn, _shared_attn_cfg(cfg),
                          cm.rmsnorm(sp.ln_attn, xcat), positions,
                          q_chunk=_q_chunk(h.shape[1]))
    return _shared_mlp(sp, _attn_out(sp, h, a), emb0)


def _apply_shared_decode(sp, cfg: ModelConfig, h, emb0, kv, cache_len):
    xcat = torch.cat([h, emb0], dim=-1)
    a, _ = attn.attend_decode(sp.attn, _shared_attn_cfg(cfg),
                              cm.rmsnorm(sp.ln_attn, xcat), kv, cache_len)
    return _shared_mlp(sp, _attn_out(sp, h, a), emb0)


def _apply_shared_prefill(sp, cfg: ModelConfig, h, emb0, positions, kv):
    xcat = torch.cat([h, emb0], dim=-1)
    a, _ = attn.attend_prefill(sp.attn, _shared_attn_cfg(cfg),
                               cm.rmsnorm(sp.ln_attn, xcat), positions, kv,
                               q_chunk=_q_chunk(h.shape[1]))
    return _shared_mlp(sp, _attn_out(sp, h, a), emb0)


def _mamba_train(m2, p, h):
    return h + mamba2.apply_train(p.mamba, m2, cm.rmsnorm(p.ln, h))


def _mamba_layers(cfg: ModelConfig, layers, h, states, apply):
    """Each Mamba layer's ``apply(p, cfg, x, state)`` (prefill or decode)
    on its slice of the stacked ``states``, written back in place."""
    m2 = _m2cfg(cfg)

    def step(p, h, state):
        o, new = apply(p.mamba, m2, cm.rmsnorm(p.ln, h), state)
        return h + o, new

    return cm.step_layers(layers, h, states, step)


def _shared_params(params, cfg: ModelConfig, gi):
    return params.shared[gi % cfg.n_shared_blocks]


def _embed_in(params, cfg: ModelConfig, tokens):
    return cm.embed_lookup(params.embed, tokens.long()).to(
        torch_dtype(cfg.compute_dtype))


# ------------------------------------------------------------------- train
def forward_train(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """tokens: (B, S) int. Returns (logits (B, S, V), aux = 0); each shared
    application and each Mamba layer under ``cm.remat`` when autograd
    records, as the reference checkpoints them."""
    emb0 = _embed_in(params, cfg, tokens)
    h = emb0
    b, s, _ = h.shape
    positions = transformer._positions(b, s, h.device)
    records = torch.is_grad_enabled() and h.requires_grad
    wrap = (lambda fn: cm.remat(cfg, fn)) if records else (lambda fn: fn)
    m2 = _m2cfg(cfg)

    def mambas(layers, h):
        for p in layers:
            h = wrap(functools.partial(_mamba_train, m2, p))(h)
        return h

    for gi, group in enumerate(params.blocks):
        h = wrap(functools.partial(_apply_shared_train,
                                   _shared_params(params, cfg, gi), cfg,
                                   emb0, positions))(h)
        h = mambas(group, h)
    if tail_layers(cfg):
        h = mambas(params.tail, h)
    h = cm.rmsnorm(params.final_norm, h)
    return (cm.embed_logits(params.embed, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


# ----------------------------------------------------------------- serving
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None):
    one_m = mamba2.init_state(_m2cfg(cfg), batch, device="meta")
    acfg = _shared_attn_cfg(cfg)
    ng, tl = n_groups(cfg), tail_layers(cfg)

    def stack(lead):
        return {k: torch.zeros(lead + tuple(a.shape), dtype=a.dtype,
                               device=device) for k, a in one_m.items()}

    kv = (ng, batch, max_len, acfg.n_kv_heads, acfg.head_dim)
    state = {"blocks": stack((ng, cfg.attn_every)),
             "shared_kv": {k: torch.zeros(kv, dtype=dtype, device=device)
                           for k in ("k", "v")},
             "len": 0}
    if tl:
        state["tail"] = stack((tl,))
    return state


def decode_state_specs(cfg: ModelConfig):
    m2spec = mamba2.state_specs()
    s = {"blocks": _prefixed(m2spec, ("layers", None)),
         "shared_kv": cm.add_layer_axis_to_specs(attn.cache_specs()),
         "len": ()}
    if tail_layers(cfg):
        s["tail"] = cm.add_layer_axis_to_specs(m2spec)
    return s


def _group_state(state, gi):
    return ({k: a[gi] for k, a in state["blocks"].items()},
            {k: a[gi] for k, a in state["shared_kv"].items()})


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, state):
    """token: (B, 1) int. Writes the Mamba states and the shared blocks'
    K/V into ``state`` in place; returns (logits (B, 1, V), the state with
    ``len`` + 1)."""
    emb0 = _embed_in(params, cfg, token)
    h = emb0
    cache_len = int(state["len"])
    for gi, group in enumerate(params.blocks):
        mstates, kv = _group_state(state, gi)
        h = _apply_shared_decode(_shared_params(params, cfg, gi), cfg, h,
                                 emb0, kv, cache_len)
        h = _mamba_layers(cfg, group, h, mstates, mamba2.apply_decode)
    if tail_layers(cfg):
        h = _mamba_layers(cfg, params.tail, h, state["tail"],
                          mamba2.apply_decode)
    h = cm.rmsnorm(params.final_norm, h)
    return cm.embed_logits(params.embed, h), dict(state, len=cache_len + 1)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, max_len: int,
            extra_embeds=None, cache_dtype=torch.bfloat16):
    """Full-sequence forward that seeds every decode state: the SSD final
    states (``chunked_gla``), the conv tails and the shared blocks' K/V
    caches.  Returns (logits of the last position, state)."""
    emb0 = _embed_in(params, cfg, tokens)
    h = emb0
    b, s, _ = h.shape
    positions = transformer._positions(b, s, h.device)
    state = constrain_state(
        init_decode_state(cfg, b, max_len, cache_dtype, h.device),
        decode_state_specs(cfg))
    for gi, group in enumerate(params.blocks):
        mstates, kv = _group_state(state, gi)
        h = _apply_shared_prefill(_shared_params(params, cfg, gi), cfg, h,
                                  emb0, positions, kv)
        h = _mamba_layers(cfg, group, h, mstates, mamba2.apply_prefill)
    if tail_layers(cfg):
        h = _mamba_layers(cfg, params.tail, h, state["tail"],
                          mamba2.apply_prefill)
    h = cm.rmsnorm(params.final_norm, h)
    state["len"] = s
    return cm.embed_logits(params.embed, h[:, -1:]), state
