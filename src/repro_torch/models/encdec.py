"""Whisper-style encoder-decoder backbone (port of
``repro.models.encdec``; arXiv:2212.04356).

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_frames, d_model).  Encoder:
bidirectional pre-LN transformer with sinusoidal positions, queries
chunked above ``transformer.Q_CHUNK``.  Decoder: causal self-attention
(KV cache), cross-attention over the encoder output, learned positions
(``dec_pos``, 8192 rows), GELU MLPs, LayerNorms with bias, logits tied
to the token embedding.

``decode_step`` reads ``dec_pos`` at the pooled length clamped to its
last row, where the reference's ``dynamic_slice_in_dim`` clamps.  The
decode state is the reference's tree (``self_kv`` stacked over the
decoder layers, bf16; ``enc_out`` in the cache dtype; ``len`` a host
int), written in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import transformer
from repro_torch.models.transformer import torch_dtype
from repro_torch.sharding.rules import constrain, constrain_state

DEC_RATIO_TRAIN = 4     # dec tokens = seq_len // 4 for train cells
DEC_RATIO_PREFILL = 32
DEC_POS = 8192          # learned decoder positions


def _attn_cfg(cfg: ModelConfig, causal: bool) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, use_bias=True, use_rope=False)


def dec_len(cfg: ModelConfig, seq_len: int, kind: str) -> int:
    if kind == "train":
        return max(64, seq_len // DEC_RATIO_TRAIN)
    return max(64, seq_len // DEC_RATIO_PREFILL)


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = cm.LayerNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = attn.Attention(_attn_cfg(cfg, False), **kw)
        self.ln2 = cm.LayerNorm(cfg.d_model, device=device, dtype=dtype)
        self.mlp = mlp_lib.PlainMLP(cfg.d_model, cfg.d_ff, **kw)


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        norm = lambda: cm.LayerNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln1 = norm()
        self.self_attn = attn.Attention(_attn_cfg(cfg, True), **kw)
        self.ln_cross = norm()
        self.cross_attn = attn.Attention(_attn_cfg(cfg, False), **kw)
        self.ln2 = norm()
        self.mlp = mlp_lib.PlainMLP(cfg.d_model, cfg.d_ff, **kw)


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=None):
        super().__init__()
        dtype = dtype or torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = cm.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.dec_pos = cm.dense_init((DEC_POS, cfg.d_model), (1,), **kw)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, **kw)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_final = cm.LayerNorm(cfg.d_model, device=device,
                                      dtype=dtype)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, **kw)
                                        for _ in range(cfg.n_dec_layers))
        self.dec_final = cm.LayerNorm(cfg.d_model, device=device,
                                      dtype=dtype)


def init_params(cfg: ModelConfig, generator=None, dtype=None, device=None):
    """Seeded random weights: ``generator`` is a ``torch.Generator`` on
    ``device`` or an int seed."""
    return EncDec(cfg, generator=cm.make_generator(generator, device),
                  device=device, dtype=dtype)


def abstract_params(cfg: ModelConfig):
    return EncDec(cfg, device="meta")


def param_shapes(params) -> dict:
    return {"embed": cm.shape_tree(params.embed),
            "dec_pos": tuple(params.dec_pos.shape),
            "enc_layers": cm.shape_tree(params.enc_layers[0],
                                        (len(params.enc_layers),)),
            "enc_final": cm.shape_tree(params.enc_final),
            "dec_layers": cm.shape_tree(params.dec_layers[0],
                                        (len(params.dec_layers),)),
            "dec_final": cm.shape_tree(params.dec_final)}


def _enc_layer_specs(cfg):
    return {"ln1": cm.layernorm_specs(),
            "attn": attn.specs(_attn_cfg(cfg, False)),
            "ln2": cm.layernorm_specs(), "mlp": mlp_lib.plain_specs()}


def _dec_layer_specs(cfg):
    return {"ln1": cm.layernorm_specs(),
            "self_attn": attn.specs(_attn_cfg(cfg, True)),
            "ln_cross": cm.layernorm_specs(),
            "cross_attn": attn.specs(_attn_cfg(cfg, False)),
            "ln2": cm.layernorm_specs(), "mlp": mlp_lib.plain_specs()}


def param_specs(cfg: ModelConfig):
    return {
        "embed": cm.embed_specs(),
        "dec_pos": (None, "embed"),
        "enc_layers": cm.add_layer_axis_to_specs(_enc_layer_specs(cfg)),
        "enc_final": cm.layernorm_specs(),
        "dec_layers": cm.add_layer_axis_to_specs(_dec_layer_specs(cfg)),
        "dec_final": cm.layernorm_specs(),
    }


def compute_copy(params):
    """The weights cast to the compute dtype once; the LayerNorms shared
    with ``params``."""
    return cm.compute_copy(params, torch_dtype(params.cfg.compute_dtype),
                           cm.is_norm)


def _sinusoid(n, d, dtype, device=None):
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _enc_layer(acfg, p, h):
    x = cm.layernorm(p.ln1, h)
    # bidirectional attention, q-chunked above Q_CHUNK
    q, k, v = attn._qkv(p.attn, acfg, x, None)
    q_chunk = transformer.Q_CHUNK
    if x.shape[1] > q_chunk:
        a = attn._sdpa_chunked(acfg, q, k, v, window=None, q_chunk=q_chunk,
                               causal=False)
    else:
        mask = torch.ones((1, 1, x.shape[1], x.shape[1]), dtype=torch.bool,
                          device=x.device)
        a = attn._sdpa(acfg, q, k, v, mask)
    h = h + attn.output_projection(a, p.attn.wo.to(x.dtype))
    h = h + mlp_lib.plain_apply(p.mlp, cm.layernorm(p.ln2, h))
    return constrain(h, "batch", None, None)


def _layers(cfg, layers, h, fn):
    records = torch.is_grad_enabled() and h.requires_grad
    for p in layers:
        h = (cm.remat(cfg, fn) if records else fn)(p, h)
    return h


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, T, d) stub frame embeddings -> (B, T, d)."""
    dt = torch_dtype(cfg.compute_dtype)
    h = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model, dt,
                                  frames.device)
    acfg = _attn_cfg(cfg, False)
    h = _layers(cfg, params.enc_layers, h,
                lambda p, h: _enc_layer(acfg, p, h))
    return cm.layernorm(params.enc_final, h)


def _dec_block(p, acfg, h, positions, enc_out, self_mode, cache=None,
               cache_len=None):
    """self_mode: "train" (causal full sequence), "prefill" (into an empty
    cache) or "decode" (one token + cache)."""
    x = cm.layernorm(p.ln1, h)
    if self_mode == "train":
        a = attn.attend_train(p.self_attn, acfg, x, positions)
    elif self_mode == "prefill":
        a, _ = attn.attend_prefill(p.self_attn, acfg, x, positions, cache)
    else:
        a, _ = attn.attend_decode(p.self_attn, acfg, x, cache, cache_len)
    h = h + a
    h = h + attn.attend_cross(p.cross_attn, acfg,
                              cm.layernorm(p.ln_cross, h), enc_out)
    h = h + mlp_lib.plain_apply(p.mlp, cm.layernorm(p.ln2, h))
    return constrain(h, "batch", None, None)


def _dec_in(params, cfg, tokens):
    dt = torch_dtype(cfg.compute_dtype)
    b, s = tokens.shape
    h = (cm.embed_lookup(params.embed, tokens.long()).to(dt)
         + params.dec_pos[:s].to(dt))
    return h, transformer._positions(b, s, h.device)


def forward_train(params, cfg: ModelConfig, batch):
    """batch: {"frames": (B, T, d), "dec_tokens": (B, S) int}.  Returns
    (logits (B, S, V), aux = 0)."""
    enc_out = encode(params, cfg, batch["frames"])
    h, positions = _dec_in(params, cfg, batch["dec_tokens"])
    acfg = _attn_cfg(cfg, True)
    h = _layers(cfg, params.dec_layers, h,
                lambda p, h: _dec_block(p, acfg, h, positions, enc_out,
                                        "train"))
    h = cm.layernorm(params.dec_final, h)
    return (cm.embed_logits(params.embed, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, dtype=torch.bfloat16, device=None):
    kv = (cfg.n_dec_layers, batch, max_len, cfg.n_kv_heads,
          cfg.resolved_head_dim)
    return {"self_kv": {k: torch.zeros(kv, dtype=dtype, device=device)
                        for k in ("k", "v")},
            "enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                   dtype=dtype, device=device),
            "len": 0}


def decode_state_specs(cfg: ModelConfig):
    return {"self_kv": cm.add_layer_axis_to_specs(attn.cache_specs()),
            "enc_out": ("batch", "kv_seq", "embed"),
            "len": ()}


def _layer_cache(state, i):
    return {k: a[i] for k, a in state["self_kv"].items()}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, max_len: int,
            cache_dtype=torch.bfloat16):
    """Encode the frames and run the decoder prompt. batch: {"frames",
    "dec_tokens"}.  Returns (logits of the last position, state)."""
    enc_out = encode(params, cfg, batch["frames"])
    h, positions = _dec_in(params, cfg, batch["dec_tokens"])
    b, s = batch["dec_tokens"].shape
    acfg = _attn_cfg(cfg, True)
    state = constrain_state(
        init_decode_state(cfg, b, max_len, enc_out.shape[1], cache_dtype,
                          h.device), decode_state_specs(cfg))
    for i, p in enumerate(params.dec_layers):
        h = _dec_block(p, acfg, h, positions, enc_out, "prefill",
                       cache=_layer_cache(state, i))
    h = cm.layernorm(params.dec_final, h)
    state["enc_out"].copy_(enc_out)
    state["len"] = s
    return cm.embed_logits(params.embed, h[:, -1:]), state


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, state):
    """token: (B, 1) int.  The position's embedding is ``dec_pos`` at the
    pooled length, clamped to the last row.  Writes the self-attention
    K/V in place; returns (logits (B, 1, V), the state with ``len`` + 1)."""
    dt = torch_dtype(cfg.compute_dtype)
    cache_len = int(state["len"])
    row = min(cache_len, params.dec_pos.shape[0] - 1)
    h = (cm.embed_lookup(params.embed, token.long()).to(dt)
         + params.dec_pos[row:row + 1].to(dt))
    acfg = _attn_cfg(cfg, True)
    enc_out = state["enc_out"].to(dt)
    for i, p in enumerate(params.dec_layers):
        h = _dec_block(p, acfg, h, None, enc_out, "decode",
                       cache=_layer_cache(state, i), cache_len=cache_len)
    h = cm.layernorm(params.dec_final, h)
    return cm.embed_logits(params.embed, h), dict(state, len=cache_len + 1)
