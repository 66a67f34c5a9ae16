"""Chunked gated linear recurrence (port of ``repro.models.gla``): the
shared engine of Mamba2 (SSD, scalar per-head decay) and RWKV6 (vector
per-channel decay + bonus).

Recurrence (per head, state S ∈ R^{dk×dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    mamba/"inclusive":  y_t = q_tᵀ S_t
    rwkv/"bonus":       y_t = q_tᵀ (S_{t-1} + diag(u ⊙ k_t)·v_t-outer)

Training and prefill use the chunked parallel form, with the reference's
numerical design: every exponential has a NON-POSITIVE exponent, so the
math is stable for any decay strength (Mamba2's log-decays reach -10 a
step):
  * cross-chunk state: q·e^{cum} (≤0), k·e^{total-cum} (≤0),
    state×e^{total}
  * intra-chunk scores by sub-blocks of ``SUB``: the diagonal sub-blocks
    take exact per-channel log differences, with the upper triangle set to
    -inf BEFORE the exp; the off-diagonal pairs (i > j) factor through the
    end of block j,
        cum_t - cum_s = (cum_t - end_j) + (end_j - cum_s),  both terms ≤ 0.
The reference builds the off-diagonal pairs in a Python double loop; here
they are one masked contraction over every (i, j) pair, the pairs with
j ≥ i given the exponent -inf (a zero factor).  The chunk recurrence is a
Python loop over the chunks (the reference's ``scan``).

All math in float32; the output is cast to ``q.dtype`` and the final
state stays float32.  Shapes: q, k, logw: (B, H, T, dk) (logw's last axis
may be 1: a scalar decay per head); v: (B, H, T, dv); u: (H, dk) | None.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import constrain, dtensor_of

SUB = 16  # sub-block (secondary chunk) size


def _intra_scores(qc, kc, qcum, kcum, *, mode: str, sub: int = SUB):
    """Stable intra-chunk score matrix.

    qc, kc: (..., C, dk).  kcum: inclusive cumulative log-decay; qcum the
    q-side reference (kcum in inclusive mode, kcum - logw in bonus mode:
    decay only through t-1).  Returns (..., C, C) with
    scores[t, s] = Σ_d q[t,d] k[s,d] e^{qcum[t,d]-kcum[s,d]}, causally
    masked (s <= t inclusive, s < t bonus)."""
    c_total, dk = qc.shape[-2], qc.shape[-1]
    sub = min(sub, c_total)
    nb = c_total // sub
    lead = qc.shape[:-2]
    dev = qc.device
    qs = qc.reshape(lead + (nb, sub, dk))
    ks = kc.reshape(lead + (nb, sub, dk))
    qcs = qcum.reshape(lead + (nb, sub, dk))
    kcs = kcum.reshape(lead + (nb, sub, dk))
    ends = kcs[..., -1:, :]                              # (..., nb, 1, dk)

    # diagonal blocks: exact per-channel log-space differences, the masked
    # exponents set before the exp (the upper triangle would overflow)
    diff = qcs[..., :, None, :] - kcs[..., None, :, :]   # (..., nb, c, c, dk)
    tri = torch.tril(torch.ones((sub, sub), dtype=torch.bool, device=dev),
                     diagonal=0 if mode == "inclusive" else -1)
    diff = torch.where(tri[..., None], diff, -torch.inf)
    diag = (torch.exp(diff) * qs[..., :, None, :]
            * ks[..., None, :, :]).sum(-1)               # (..., nb, c, c)
    if nb == 1:
        return diag[..., 0, :, :]

    # off-diagonal pairs (i > j), every exponent <= 0; pairs j >= i get -inf
    below = torch.tril(torch.ones((nb, nb), dtype=torch.bool, device=dev),
                       diagonal=-1)
    expo = qcs[..., :, None, :, :] - ends[..., None, :, :, :]
    qd = qs[..., :, None, :, :] * torch.exp(
        torch.where(below[:, :, None, None], expo, -torch.inf))
    kd = ks * torch.exp(ends - kcs)                      # (..., nb, c, dk)
    off = torch.einsum("...ijtd,...jsd->...ijts", qd, kd)
    eye = torch.eye(nb, dtype=torch.bool, device=dev)[:, :, None, None]
    blocks = torch.where(eye, diag[..., :, None, :, :], off)
    return blocks.transpose(-3, -2).reshape(lead + (c_total, c_total))


def chunked_gla(q, k, v, logw, *, u=None, initial_state=None,
                chunk: int = 64, mode: str = "inclusive"):
    """Returns (y: (B, H, T, dv) in q's dtype, final_state: (B, H, dk, dv)
    float32).  A ragged T is padded inertly to a multiple of ``chunk``:
    q = k = v = 0 add nothing, logw = 0 passes the state through.  Under
    a mesh it runs on each rank's blocks (``_on_local_blocks``)."""
    if mode not in ("inclusive", "bonus"):
        raise ValueError(mode)
    from repro_torch.launch.mesh import current_mesh
    if current_mesh() is not None:
        return _on_local_blocks(q, k, v, logw, u=u,
                                initial_state=initial_state, chunk=chunk,
                                mode=mode)
    return _chunked(q, k, v, logw, u=u, initial_state=initial_state,
                    chunk=chunk, mode=mode)


def _on_local_blocks(q, k, v, logw, *, u, initial_state, chunk, mode):
    """``chunked_gla`` under a mesh, on each rank's own blocks: every
    (batch row, head) pair runs its recurrence alone, so once q, k, v,
    logw and the initial state are laid out with the batch over the data
    axes, the heads over "model" and the sequence whole (a DTensor may
    arrive split along it), the plain recurrence on the local blocks
    computes this rank's block exactly.  DTensor's own strategies fail on
    some torch releases (the batched products flatten a sharded head
    axis; the pad of a ragged sequence reaches its redistribute planner).
    The redistributes are ``constrain``s; ``to_local``/``from_local``
    carry the gradients, ``u``'s a partial sum over the batch's split."""
    from torch.distributed.tensor import Partial, Shard
    b, h, t, _ = q.shape
    con = lambda a: constrain(a, "batch", "heads", None, None)
    q, k, v = con(q), con(k), con(v)
    logw = con(logw.expand(b, h, t, logw.shape[-1]))
    mesh, split = q.device_mesh, q.placements
    if initial_state is not None:
        initial_state = con(initial_state).to_local()
    if u is not None:
        u = constrain(u, "heads", None)
        u = u.to_local(grad_placements=[
            Partial() if pl == Shard(0) else up
            for pl, up in zip(split, u.placements)])
    y, s = _chunked(q.to_local(), k.to_local(), v.to_local(),
                    logw.to_local(), u=u, initial_state=initial_state,
                    chunk=chunk, mode=mode)
    return (dtensor_of(y, mesh, split, (b, h, t, v.shape[-1])),
            dtensor_of(s, mesh, split, (b, h) + tuple(s.shape[2:])))


def _chunked(q, k, v, logw, *, u, initial_state, chunk, mode):
    """``chunked_gla`` on plain tensors."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    t_orig = t
    pad = (-t) % chunk
    logw = logw.expand(b, h, t, logw.shape[-1])
    if pad:
        zpad = lambda a: F.pad(a, (0, 0, 0, pad))
        q, k, v, logw = zpad(q), zpad(k), zpad(v), zpad(logw)
        t = t + pad
    nc = t // chunk
    f32 = torch.float32
    lw = logw.to(f32).expand(b, h, t, dk)

    resh = lambda a, d: a.to(f32).reshape(b, h, nc, chunk, d)
    qc, kc, vc = resh(q, dk), resh(k, dk), resh(v, dv)
    lwc = resh(lw, dk)
    cum = torch.cumsum(lwc, dim=-2)                    # inclusive cumsum
    total = cum[..., -1:, :]                           # (B, H, nc, 1, dk)

    # decay applied to the incoming state when it contributes to y_t
    q_decay = cum if mode == "inclusive" else cum - lwc
    qd_state = qc * torch.exp(q_decay)                 # exponent <= 0
    k_tail = kc * torch.exp(total - cum)               # exponent <= 0

    scores = _intra_scores(qc, kc, q_decay, cum, mode=mode)
    y_intra = scores @ vc
    if mode == "bonus":
        uu = (u if u is not None
              else torch.ones((h, dk), dtype=f32, device=q.device)).to(f32)
        diag = (qc * uu[None, :, None, None, :] * kc).sum(-1)
        y_intra = y_intra + diag[..., None] * vc

    s = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
         if initial_state is None else initial_state.to(f32))
    y_inter = []
    for n in range(nc):
        y_inter.append(qd_state[:, :, n] @ s)
        s = (torch.exp(total[:, :, n, 0, :])[..., None] * s
             + k_tail[:, :, n].transpose(-1, -2) @ vc[:, :, n])
    y = y_intra + torch.stack(y_inter, dim=2)
    y = y.reshape(b, h, t, dv)[:, :, :t_orig]
    return y.to(q.dtype), s


def gla_decode_step(q, k, v, logw, state, *, u=None, mode: str = "inclusive"):
    """One-token recurrence. q, k, logw: (B, H, dk) (logw may be (B, H, 1));
    v: (B, H, dv); state: (B, H, dk, dv).  Returns (y: (B, H, dv),
    new_state float32)."""
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    w = torch.exp(logw.to(f32).expand(qf.shape))
    kv = kf[..., :, None] * vf[..., None, :]           # (B, H, dk, dv)
    s = state.to(f32)
    if mode == "inclusive":
        s_new = w[..., None] * s + kv
        y = torch.einsum("bhk,bhkv->bhv", qf, s_new)
    elif mode == "bonus":
        bonus = (u.to(f32) if u is not None
                 else torch.ones(qf.shape[1:], dtype=f32, device=q.device))
        y = torch.einsum("bhk,bhkv->bhv", qf, s + bonus[..., None] * kv)
        s_new = w[..., None] * s + kv
    else:
        raise ValueError(mode)
    return y.to(q.dtype), s_new


def reference_recurrence(q, k, v, logw, *, u=None, initial_state=None,
                         mode: str = "inclusive"):
    """The O(T) step-by-step oracle of ``chunked_gla`` (float32)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.to(torch.float32))
    lw = logw.expand(b, h, t, logw.shape[-1])
    ys = []
    for i in range(t):
        y, s = gla_decode_step(q[:, :, i], k[:, :, i], v[:, :, i],
                               lw[:, :, i], s, u=u, mode=mode)
        ys.append(y)
    return torch.stack(ys, dim=2), s
