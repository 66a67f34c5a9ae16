"""Grouped-query attention with RoPE, optional QKV bias, logit softcap,
sliding-window masking, and a KV cache for decode (port of
``repro.models.attention``).

Covers: llama-family (internlm2/yi/mistral-llava), qwen1.5 (QKV bias),
gemma2 (softcap + local/global alternation), dbrx/phi3.5 (GQA MoE
backbones) and whisper's cross attention.

Head ``h`` reads kv-head ``h // (n_heads // n_kv_heads)``, as the
reference's ``(b, s, kh, group, hd)`` reshape does.  Logits are float32
(the bf16 operands are exact in float32, so an upcast before the product
is the reference's ``preferred_element_type=float32``), and the softmax is
float32 cast back.  The cache is written in place: ``attend_decode``
writes one row at ``min(cache_len, max_len - 1)``, the start JAX's
``dynamic_update_slice`` clamps to, so a pooled length past the buffer
overwrites its last row as the reference does instead of raising.

Under a mesh, attention runs on each rank's own blocks
(``_on_local_blocks``), and decode reads the cache where its layout put
it: split by head_dim, the partial logits are all-reduced
(``_over_head_dim``); split by kv_seq, the blocks' softmax statistics are
combined (``_over_kv_seq``) and each new row is written by the rank that
holds its position (``_write_rows``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.models import common as cm
from repro_torch.sharding.rules import constrain

NEG_INF = -2.3819763e38  # large negative, bf16-safe (matches gemma impls)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    use_bias: bool = False               # qwen1.5-style QKV bias
    logit_softcap: float | None = None   # gemma2: 50.0
    query_scale: float | None = None     # default 1/sqrt(head_dim)
    use_rope: bool = True                # whisper uses absolute pos instead
    # shard the query sequence over the tensor-parallel axis (under a mesh)
    # instead of the heads, for head counts that do not divide it
    seq_shard: bool = False


class Attention(nn.Module):
    def __init__(self, cfg: AttnConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wq = cm.dense_init((d, h, hd), (0,), **kw)
        self.wk = cm.dense_init((d, kh, hd), (0,), **kw)
        self.wv = cm.dense_init((d, kh, hd), (0,), **kw)
        self.wo = cm.dense_init((h, hd, d), (0, 1), **kw)
        if cfg.use_bias:
            self.bq = cm.zeros((h, hd), device=device, dtype=dtype)
            self.bk = cm.zeros((kh, hd), device=device, dtype=dtype)
            self.bv = cm.zeros((kh, hd), device=device, dtype=dtype)


def specs(cfg: AttnConfig):
    s = {
        "wq": ("embed", "q_heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("q_heads", "head_dim", "embed"),
    }
    if cfg.use_bias:
        s["bq"] = ("q_heads", "head_dim")
        s["bk"] = ("kv_heads", "head_dim")
        s["bv"] = ("kv_heads", "head_dim")
    return s


def _project(x, w, heads_axis):
    """x (b, s, d) @ w (d, h, hd) -> (b, s, h, hd) as one product over the
    merged (h, hd) columns, the product ``einsum("bsd,dhk->bshk")`` lowers
    to (the same bits).  Under a mesh the merged columns keep a shard only
    where the heads divide it, so the split back into (h, hd) is even:
    DTensor may shard the merged columns anywhere, and cannot split them
    unevenly.  The weight is taken in the base layout (d over the data
    axes, the heads over "model" where they divide it, head_dim whole):
    a head_dim shard (the decode rules' fallback) would leave the merged
    columns a strided shard, which the product has no strategy for."""
    b, s, _ = x.shape
    d, h, hd = w.shape
    w = constrain(w.to(x.dtype), "embed", heads_axis, None)
    y = torch.einsum("bsd,dn->bsn", x, w.reshape(d, h * hd))
    y = constrain(y, "batch", None, heads_axis, dims=(b, s, h))
    # (the same layout again: the gradient reaches the split contiguous)
    return constrain(y.reshape(b, s, h, hd), "batch", None, heads_axis,
                     None)


def output_projection(out, wo):
    """out (b, s, h, hd) @ wo (h, hd, d) -> (b, s, d) as one product over
    the merged (h, hd) rows, the product ``einsum("bshk,hkd->bsd")``
    lowers to (the same bits).  Under a mesh the merged activations keep a
    head shard only where the heads divide it, in both directions: the
    gradient's split back into (h, hd) must be even too."""
    b, s, h, hd = out.shape
    o = constrain(out.reshape(b, s, h * hd), "batch", None, "q_heads",
                  dims=(b, s, h))
    w = constrain(wo.to(out.dtype), "q_heads", None, "embed")
    return torch.einsum("bsn,nd->bsd", o, w.reshape(h * hd, w.shape[-1]))


def _qkv(p, cfg: AttnConfig, x, positions):
    q = _project(x, p.wq, "q_heads")
    k = _project(x, p.wk, "kv_heads")
    v = _project(x, p.wv, "kv_heads")
    if cfg.use_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if cfg.use_rope:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    # pin the layout: batch over the data axes, heads over "model" where
    # they divide it; seq_shard puts the query sequence there instead
    if cfg.seq_shard:
        q = constrain(q, "batch", "q_seq", None, None,
                      overrides={"q_seq": "model"})
    else:
        q = constrain(q, "batch", None, "q_heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    return q, k, v


def _sdpa(cfg: AttnConfig, q, k, v, mask):
    """q: (b, sq, h, hd); k/v: (b, skv, kh, hd); mask: (b|1, 1, sq, skv)."""
    if _is_dtensor(q):
        split = _cache_split(k)
        if split == 3:
            return _over_head_dim(cfg, q, k, v, mask)
        if split == 1:
            return _over_kv_seq(cfg, q, k, v, mask)
        return _on_local_blocks(
            cfg, q, k, v, lambda ql, kl, vl, rows, qoff: _sdpa(
                cfg, ql, kl, vl, _local_mask(mask, rows, qoff, ql.shape[1])))
    probs = torch.softmax(_masked(cfg, _logits(cfg, q, k), mask), dim=-1)
    return _weighted(probs.to(q.dtype), v)


def _logits(cfg: AttnConfig, q, k):
    """(b, kh, group, sq, skv) float32 logits of q (b, sq, h, hd) against
    k (b, skv, kh, hd), before the soft-cap and the mask (head_dim may be
    a block of the heads' own: the scale is the whole head's)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    scale = cfg.query_scale or (1.0 / math.sqrt(cfg.head_dim))
    qg = q.reshape(b, sq, kh, h // kh, hd) * scale
    return torch.einsum("bqhgk,bshk->bhgqs", qg.float(), k.float())


def _masked(cfg: AttnConfig, logits, mask):
    if cfg.logit_softcap:
        logits = cm.softcap(logits, cfg.logit_softcap)
    # mask: (b|1, 1, sq, skv) -> broadcast over (kh, group)
    return torch.where(mask[:, :, None], logits, NEG_INF)


def _weighted(probs, v):
    """probs (b, kh, group, sq, skv) · v (b, skv, kh, hd) -> (b, sq, h,
    hd)."""
    b, kh, group, sq, _ = probs.shape
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(b, sq, kh * group, v.shape[-1])


def _sdpa_chunked(cfg: AttnConfig, q, k, v, *, window: int | None,
                  q_chunk: int, offset: int = 0, causal: bool = True):
    """Query-chunked attention: the peak logits buffer is (b, kh, g,
    q_chunk, skv) instead of O(sq·skv).  Each chunk sees the full K/V with
    its own causal/window mask slice."""
    if _is_dtensor(q) and _cache_split(k) is None:
        return _on_local_blocks(
            cfg, q, k, v, lambda ql, kl, vl, rows, qoff: _sdpa_chunked(
                cfg, ql, kl, vl, window=window,
                q_chunk=min(q_chunk, ql.shape[1]),   # a sequence shard
                offset=offset + qoff, causal=causal))
    b, sq, h, hd = q.shape
    assert sq % q_chunk == 0, (sq, q_chunk)
    outs = []
    for i in range(sq // q_chunk):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        if causal:
            mask = causal_mask(q_chunk, k.shape[1], window=window,
                               offset=offset + i * q_chunk, device=q.device)
        else:
            mask = torch.ones((1, 1, q_chunk, k.shape[1]), dtype=torch.bool,
                              device=q.device)
        outs.append(_sdpa(cfg, qi, k, v, mask))
    return torch.cat(outs, dim=1)


# ------------------------------------------------------- under a mesh
def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _on_local_blocks(cfg: AttnConfig, q, k, v, fn):
    """Attention of DTensors run on each rank's own blocks: every (batch
    row, head) pair attends independently, so once q, k and v are laid out
    with the batch over the data axes and the heads over "model" (the kv
    heads where they divide it; else, with ``seq_shard``, the query
    sequence; else the q heads where they divide it, each rank reading the
    kv heads its own q heads use; else replicated), ``fn(q, k, v, batch
    rows, query offset)`` on the local blocks computes this rank's block
    of the output exactly.  DTensor's own strategies would shard the
    products' merged dimensions in ways the splits after them cannot take.
    The redistributes are ``constrain``s; ``to_local``/``from_local``
    carry the gradients."""
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.sharding.rules import dtensor_of, spec_for
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    mesh = q.device_mesh
    if cfg.seq_shard and spec_for(mesh, ("kv_heads",), dims=(kh,))[0] is None:
        q = constrain(q, "batch", "q_seq", None, None,
                      overrides={"q_seq": "model"})
    else:
        q = constrain(q, "batch", None, "q_heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    rows = _block_range(mesh, q.placements, 0, b)
    qoff = _block_range(mesh, q.placements, 1, sq)[0]
    # where the queries are split and the keys are not (a query-sequence
    # shard, or q heads whose kv heads do not divide "model"), each rank's
    # key and value gradients are its queries' share: partial sums over
    # that mesh dimension
    kv_grad = [Partial() if isinstance(qp, Shard) and not
               isinstance(kp, Shard) else kp
               for qp, kp in zip(q.placements, k.placements)]
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    heads = _block_range(mesh, q.placements, 2, h)
    if kl.shape[2] == kh and heads != (0, h):
        kl, vl = _kv_heads_of(heads, h // kh, kl, vl)
    out = fn(q.to_local(), kl, vl, rows, qoff)
    return dtensor_of(out, mesh, q.placements, (b, sq, h, hd))


def _kv_heads_of(heads, group, k, v):
    """The kv heads that q heads [heads[0], heads[1]) read (q head i reads
    kv head i // group), from k and v holding every kv head: one kv head
    where the q heads fall in one group, else one per q head (so the
    local group is 1)."""
    lo, hi = heads
    if group % (hi - lo) == 0:
        j = lo // group
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    idx = torch.arange(lo, hi, device=k.device) // group
    return k.index_select(2, idx), v.index_select(2, idx)


# ----------------------------------------- decode on a split K/V cache
def _cache_split(k):
    """The dimension of a K/V cache (b, skv, kh, hd) that a mesh dimension
    of more than one rank splits other than the batch and the kv heads:
    1 (kv_seq, the long-context rules), 3 (head_dim, the decode rules'
    fallback where the kv heads do not divide "model") or None."""
    from torch.distributed.tensor import Shard
    if not _is_dtensor(k):
        return None
    mesh = k.device_mesh
    split = {p.dim for i, p in enumerate(k.placements)
             if isinstance(p, Shard) and p.dim in (1, 3) and mesh.size(i) > 1}
    if len(split) > 1:
        raise ValueError(f"a K/V cache split over both kv_seq and head_dim "
                         f"({k.placements}) has no attention here")
    return split.pop() if split else None


def _mapped(placements, dims: dict, partial: str | None = None):
    """``placements`` of a (b, skv, kh, hd) cache carried to another
    tensor: ``Shard(d)`` becomes ``Shard(dims[d])``, or, where ``dims``
    has no ``d``, ``Partial(partial)`` (a sum or max over that split still
    to reduce) or ``Replicate``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = []
    for p in placements:
        if not isinstance(p, Shard):
            out.append(p)
        elif p.dim in dims:
            out.append(Shard(dims[p.dim]))
        else:
            out.append(Partial(partial) if partial else Replicate())
    return out


def _over_head_dim(cfg: AttnConfig, q, k, v, mask):
    """Decode on a cache whose head_dim is split over "model" (the decode
    rules where the kv heads do not divide it), as the reference contracts
    it: q laid out as the cache (its head_dim split alike), each rank's
    q·kᵀ over its own head_dim block, one all-reduce of the (b, h, sq,
    skv) partial logits, the soft-cap, mask and softmax on the sums, and
    p·v on the rank's block of v: the output leaves head_dim-split and is
    laid out by the q heads again.  The cache does not move."""
    from repro_torch.sharding.rules import dtensor_of, relayout
    b, sq, h, hd = q.shape
    kh, skv = k.shape[2], k.shape[1]
    mesh = k.device_mesh
    q = relayout(q, k.placements)
    v = relayout(v, k.placements)
    part = dtensor_of(_logits(cfg, q.to_local(), k.to_local()), mesh,
                      _mapped(k.placements, {0: 0, 2: 1}, "sum"),
                      (b, kh, h // kh, sq, skv))
    logits = relayout(part, _mapped(k.placements, {0: 0, 2: 1})).to_local()
    rows = _block_range(mesh, k.placements, 0, b)
    probs = torch.softmax(_masked(cfg, logits,
                                  _local_mask(mask, rows, 0, sq)), dim=-1)
    out = _weighted(probs.to(q.dtype), v.to_local())
    out = dtensor_of(out, mesh, k.placements, (b, sq, h, hd))
    return constrain(out, "batch", None, "q_heads", None)


def _over_kv_seq(cfg: AttnConfig, q, k, v, mask):
    """Decode on a cache whose kv_seq is split (the long-context rules),
    combined as flash decoding does: q whole on every block of key
    positions, each rank's logits masked at its block's global positions,
    an all-reduce of the blocks' maxima, each rank's exp(logits - max)
    and its sum, an all-reduce of the sums, and an all-reduce of each
    rank's normalized p·v.  A fully masked block holds NEG_INF logits,
    whose exp against the global (finite) maximum is 0: it adds nothing.
    The cache does not move."""
    from repro_torch.sharding.rules import dtensor_of, relayout
    b, sq, h, hd = q.shape
    kh, skv = k.shape[2], k.shape[1]
    mesh = k.device_mesh
    q = relayout(q, _mapped(k.placements, {0: 0, 2: 2, 3: 3}))
    v = relayout(v, k.placements)
    rows = _block_range(mesh, k.placements, 0, b)
    lo, hi = _block_range(mesh, k.placements, 1, skv)
    logits = _masked(cfg, _logits(cfg, q.to_local(), k.to_local()),
                     _local_mask(mask, rows, 0, sq)[..., lo:hi])
    stat, st = (b, kh, h // kh, sq, 1), {0: 0, 2: 1}   # (kh at dim 1)
    top = relayout(dtensor_of(logits.amax(dim=-1, keepdim=True), mesh,
                              _mapped(k.placements, st, "max"), stat),
                   _mapped(k.placements, st)).to_local()
    e = torch.exp(logits - top)
    total = relayout(dtensor_of(e.sum(dim=-1, keepdim=True), mesh,
                                _mapped(k.placements, st, "sum"), stat),
                     _mapped(k.placements, st)).to_local()
    # the partial outputs sum in float32 and round to q's dtype once
    probs = (e / total).to(q.dtype)
    out = _weighted(probs.float(), v.to_local().float())
    heads = {0: 0, 2: 2, 3: 3}
    out = relayout(dtensor_of(out, mesh, _mapped(k.placements, heads, "sum"),
                              (b, sq, h, hd)),
                   _mapped(k.placements, heads))
    return constrain(out.to(q.dtype), "batch", None, "q_heads", None)


def _write_rows(cache, start: int, rows):
    """``cache[:, start:start + n] = rows`` in place, for rows (b, n, kh,
    hd).  On a cache split over kv_seq each rank writes the rows its own
    block holds into that block, from the rows laid out as the cache is
    save for kv_seq: no block of the cache moves."""
    n = rows.shape[1]
    if _cache_split(cache) != 1:
        cache[:, start:start + n] = rows.to(cache.dtype)
        return
    from repro_torch.sharding.rules import relayout
    lo, hi = _block_range(cache.device_mesh, cache.placements, 1,
                          cache.shape[1])
    rows = relayout(rows.to(cache.dtype),
                    _mapped(cache.placements, {0: 0, 2: 2, 3: 3}))
    a, z = max(start, lo), min(start + n, hi)
    if a < z:
        cache.to_local()[:, a - lo:z - lo] = rows.to_local()[:, a - start:
                                                             z - start]


def _block_range(mesh, placements, dim, size):
    """(start, stop) of this rank's block of tensor dim ``dim`` (of global
    ``size``) under ``placements`` (whole, or split major to minor over
    the mesh dims that shard it)."""
    from torch.distributed.tensor import Shard
    start, n = 0, size
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= mesh.size(i)
            start += mesh.get_local_rank(i) * n
    return start, start + n


def _local_mask(mask, rows, qoff, sq_local):
    """The rows of a global (b|1, 1, sq, skv) mask for a local block."""
    if mask.shape[0] > 1:
        mask = mask[rows[0]:rows[1]]
    return mask[:, :, qoff:qoff + sq_local]


def causal_mask(sq, skv, *, window: int | None = None, offset: int = 0,
                device=None):
    """(1, 1, sq, skv) bool. offset = absolute position of query 0 minus
    key 0.  window = sliding-window size (gemma2 local layers): the key
    position must be within [qpos - window + 1, qpos]."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None]


def attend_train(p, cfg: AttnConfig, x, positions, *,
                 window: int | None = None, q_chunk: int | None = None):
    q, k, v = _qkv(p, cfg, x, positions)
    sq = x.shape[1]
    if q_chunk and sq > q_chunk:
        out = _sdpa_chunked(cfg, q, k, v, window=window, q_chunk=q_chunk)
    else:
        out = _sdpa(cfg, q, k, v,
                    causal_mask(sq, sq, window=window, device=x.device))
    return output_projection(out, p.wo)


# ------------------------------------------------------------------ KV cache
def init_cache(cfg: AttnConfig, batch, max_len, dtype=torch.bfloat16,
               device=None):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_specs():
    return {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim")}


def attend_prefill(p, cfg: AttnConfig, x, positions, cache, *,
                   window: int | None = None, q_chunk: int | None = None):
    """Prefill seq into an (empty) cache, written in place; returns
    (out, cache)."""
    q, k, v = _qkv(p, cfg, x, positions)
    sq = x.shape[1]
    if sq > cache["k"].shape[1]:
        raise ValueError(f"a prompt of {sq} tokens does not fit a cache of "
                         f"{cache['k'].shape[1]}")
    _write_rows(cache["k"], 0, k)
    _write_rows(cache["v"], 0, v)
    if q_chunk and sq > q_chunk:
        out = _sdpa_chunked(cfg, q, k, v, window=window, q_chunk=q_chunk)
    else:
        out = _sdpa(cfg, q, k, v,
                    causal_mask(sq, sq, window=window, device=x.device))
    return output_projection(out, p.wo), cache


def attend_decode(p, cfg: AttnConfig, x, cache, cache_len: int, *,
                  window: int | None = None):
    """One-token decode. x: (b, 1, d); cache_len: tokens already in the
    cache (a host int).  Attention runs over the whole cache buffer with
    positions > cache_len masked out, as the reference's static-shape
    decode does.  Writes the cache in place; returns (out, cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    ck, cv = cache["k"], cache["v"]
    skv = ck.shape[1]
    start = min(cache_len, skv - 1)       # JAX clamps the update's start
    _write_rows(ck, start, k)
    _write_rows(cv, start, v)
    kpos = torch.arange(skv, device=x.device)[None, :]
    valid = kpos <= cache_len
    if window is not None:
        valid &= kpos > cache_len - window
    mask = valid[:, None, None, :].expand(b, 1, 1, skv)
    out = _sdpa(cfg, q, ck.to(q.dtype), cv.to(q.dtype), mask)
    return output_projection(out, p.wo), cache


# -------------------------------------------------------- cross attention
def attend_cross(p, cfg: AttnConfig, x, kv_feats, kv_mask=None):
    """Whisper decoder cross-attention. kv_feats: (b, s_enc, d)."""
    q = _project(x, p.wq, "q_heads")
    k = _project(kv_feats, p.wk.to(x.dtype), "kv_heads")
    v = _project(kv_feats, p.wv.to(x.dtype), "kv_heads")
    if cfg.use_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    b, sq, skv = x.shape[0], x.shape[1], kv_feats.shape[1]
    if kv_mask is None:
        mask = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=x.device)
    else:
        mask = kv_mask[:, None, None, :].expand(b, 1, sq, skv)
    out = _sdpa(cfg, q, k, v, mask)
    return output_projection(out, p.wo)
