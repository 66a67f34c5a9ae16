"""Mixture-of-Experts FFN: top-k softmax router + grouped capacity-bounded
dispatch (GShard, arXiv:2006.16668); port of ``repro.models.moe``.

Tokens are cut into row-local groups of ``group_size`` (a group never
straddles two batch rows, so capacity dropping is a per-row prefix
property and prefill over s-1 tokens drops exactly what the full forward
drops in its first s-1 positions).  Each group scatters into per-expert
capacity buffers through one-hot products, the experts' FFNs run batched
over the expert axis, and the results are combined with the renormalized
router gates; dropped tokens fall through via the residual stream.

Selection is on ``floor(16·p)``, which turns near-ties into exact ties;
the reference's ``lax.top_k`` breaks those to the lower expert index, and
``torch.topk`` promises no order among ties, so the port selects on the
composite key ``floor(16·p)·E + (E - 1 - e)``: distinct per expert, exact
in float32 (at most 16·E + E - 1), and ordered as ``lax.top_k`` orders
(descending, the lower index first among equals).  The gates are the
exact probabilities gathered at the selected experts, so under autograd
the router's gradient comes through them and the aux loss; the selection
(the floor, the top-k indices, the one-hots and the capacity mask)
carries none.

An aux load-balancing loss (Switch §2.2, per group then averaged) is
returned alongside.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.sharding.rules import constrain


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    group_size: int = 256     # tokens per dispatch group


class MoE(nn.Module):
    def __init__(self, cfg: MoEConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.router = cm.dense_init((d, e), (0,), **kw)
        self.w_gate = cm.dense_init((e, d, f), (1,), **kw)
        self.w_up = cm.dense_init((e, d, f), (1,), **kw)
        self.w_down = cm.dense_init((e, f, d), (1,), **kw)


def specs(cfg: MoEConfig):
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "mlp"),
        "w_up": ("experts", "embed", "mlp"),
        "w_down": ("experts", "mlp", "embed"),
    }


def group_capacity(cfg: MoEConfig, group: int) -> int:
    cap = int(cfg.capacity_factor * group * cfg.top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)  # pad to a multiple of 8


def route(probs, top_k: int):
    """(gate_idx, gate_vals) of the top_k experts on floor(16·p), exact
    ties to the lower index, gates renormalized.  A DTensor (its expert
    axis whole) is routed on each rank's own rows: DTensor's top-k keys
    its sharding cache without ``k``, so two configs of one expert count
    and other ``top_k`` in one process would read each other's shapes."""
    from torch.distributed.tensor import DTensor
    if isinstance(probs, DTensor):
        from repro_torch.sharding.rules import dtensor_of
        idx, vals = route(probs.to_local(), top_k)
        shape = tuple(probs.shape[:-1]) + (top_k,)
        return tuple(dtensor_of(t, probs.device_mesh, probs.placements,
                                shape) for t in (idx, vals))
    e = probs.shape[-1]
    qsel = torch.floor(probs * 16.0)
    lower_first = (e - 1) - torch.arange(e, device=probs.device,
                                         dtype=probs.dtype)
    _, gate_idx = torch.topk(qsel * e + lower_first, top_k, dim=-1,
                             sorted=True)
    gate_vals = torch.gather(probs, -1, gate_idx)
    return gate_idx, gate_vals / gate_vals.sum(-1, keepdim=True)


def _combine(combine, expert_out):
    """(g,s,d): Σ over (e,c) of combine (g,s,e,c) · expert_out (e,g,c,d).
    Under a mesh the product runs on each rank's blocks, the groups and
    the experts split alike in both (DTensor's strategy for it flattens a
    sharded expert axis, which some torch releases refuse); where the
    experts are split, each rank's result is a partial sum over them,
    which the constraint after it reduces."""
    from torch.distributed.tensor import DTensor
    if not isinstance(expert_out, DTensor):
        return torch.einsum("gsec,egcd->gsd", combine, expert_out)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.rules import dtensor_of
    combine = constrain(combine, "batch", None, "experts", None)
    expert_out = constrain(expert_out, "experts", "batch", None, None)
    out = torch.einsum("gsec,egcd->gsd", combine.to_local(),
                       expert_out.to_local())
    split = [Shard(0) if pl == Shard(0) else
             Partial() if pl == Shard(2) else Replicate()
             for pl in combine.placements]
    g, s = combine.shape[:2]
    out = dtensor_of(out, combine.device_mesh, split,
                     (g, s, expert_out.shape[-1]))
    return constrain(out, "batch", None, None)


def apply(p, cfg: MoEConfig, x):
    """x: (b, s, d) -> (out, aux_loss). Routing in float32."""
    b, s, d = x.shape
    sg = min(cfg.group_size, s)
    assert s % sg == 0, (s, sg)
    g = b * (s // sg)
    cap = group_capacity(cfg, sg)
    e, k = cfg.n_experts, cfg.top_k
    xt = constrain(x.reshape(g, sg, d), "batch", None, None)

    # the router's logits whole over the experts: the top-k and one-hot
    # below take no sharded expert axis (DTensor has no strategy for them)
    logits = constrain(torch.einsum("gsd,de->gse", xt.float(),
                                    p.router.float()), "batch", None, None)
    probs = torch.softmax(logits, dim=-1)                     # (g,s,e)
    gate_idx, gate_vals = route(probs, k)                     # (g,s,k)

    # position of each (token, k) inside its expert's per-group buffer
    onehot = F.one_hot(gate_idx, e).to(torch.int32)           # (g,s,k,e)
    flat = onehot.reshape(g, sg * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, sg, k, e)
    pos = torch.sum(pos * onehot, dim=-1)                     # (g,s,k)
    keep = pos < cap
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    # (g,s,e,c): a token occupies at most one (e,c) slot per k.  A dropped
    # (token, k) has no slot: jax.nn.one_hot gives a zero row at pos >= cap
    # where F.one_hot would raise, so the position is masked first.
    slot = F.one_hot(torch.where(keep, pos, 0), cap) * keep[..., None]
    disp = torch.einsum("gske,gskc->gsec",
                        (onehot * keep[..., None]).to(x.dtype),
                        slot.to(x.dtype))
    expert_in = constrain(torch.einsum("gsec,gsd->egcd", disp, xt),
                          "experts", "batch", None, None)     # (e,g,c,d)

    gate = torch.einsum("egcd,edf->egcf", expert_in, p.w_gate.to(x.dtype))
    up = torch.einsum("egcd,edf->egcf", expert_in, p.w_up.to(x.dtype))
    act = cm.swiglu(gate, up) if cfg.activation == "silu" \
        else cm.geglu(gate, up)
    expert_out = torch.einsum("egcf,efd->egcd", act,
                              p.w_down.to(x.dtype))           # (e,g,c,d)

    weights = torch.einsum("gske,gsk->gse", onehot.to(gate_vals.dtype),
                           gate_vals).to(x.dtype)
    combine = disp * weights[..., None]                       # (g,s,e,c)
    out = _combine(combine, expert_out).reshape(b, s, d)

    # Switch aux loss: e * Σ_e (frac tokens to e) * (mean router prob e)
    frac = torch.mean(onehot.float().sum(dim=2), dim=(0, 1))
    pmean = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac / k * pmean)
    return out, aux
