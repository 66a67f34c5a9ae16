"""The train step (port of ``repro.train.train_step``): loss, mixed
precision, microbatch gradient accumulation, MoE aux loss, z-loss.

The train state is ``{"params": model, "opt": {"mu", "nu", "count"},
"step"}``: ``params`` the model's ``nn.Module`` of float32 masters,
``mu``/``nu`` dicts keyed by its parameter names, ``count`` and ``step``
int32 scalars on the model's device.

The compute cast runs inside autograd at every step, as the reference's
``_loss_fn`` does: each master is taken as a leaf, every floating leaf is
cast to ``cfg.compute_dtype``, and the model reads the cast tensors
through ``model.param_view``, so the gradients land on the float32
masters.  (``transformer.compute_copy`` casts once, outside autograd: a
trainer built on it would leave the masters without gradients.)
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelAPI
from repro_torch.models.transformer import torch_dtype
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt_lib.AdamWConfig = opt_lib.AdamWConfig()
    microbatches: int = 1          # grad accumulation splits of the batch
    z_loss: float = 1e-4
    aux_loss_weight: float = 1e-2  # MoE load-balance loss


def cross_entropy(logits, labels, loss_mask):
    """logits (B,S,V) any float dtype; labels (B,S) int; mask (B,S).
    Returns (mean masked NLL, mean masked logsumexp²), float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    mask = loss_mask.to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll * mask) / denom, torch.sum(lse * lse * mask) / denom


def _named(params) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _loss_fn(model: ModelAPI, tc: TrainConfig, params, batch):
    """``params``: {parameter name: tensor} (or the model).  Returns
    (loss, {"ce", "aux", "z"})."""
    compute = torch_dtype(model.cfg.compute_dtype)
    cparams = {k: (v.to(compute) if v.is_floating_point() else v)
               for k, v in _named(params).items()}
    logits, aux = model.forward_train(model.param_view(cparams), batch)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    ce, zsq = cross_entropy(logits, labels, mask)
    loss = ce + tc.z_loss * zsq + tc.aux_loss_weight * aux
    return loss, {"ce": ce, "aux": aux, "z": zsq}


def init_train_state(model: ModelAPI, rng=0, device=None):
    """``rng``: an int seed or a ``torch.Generator`` on ``device``
    (``None`` means CUDA)."""
    params = model.init_params(rng, dtype=torch_dtype(model.cfg.param_dtype),
                               device=resolve_device(device))
    dev = next(params.parameters()).device
    return {"params": params, "opt": opt_lib.init_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_train_state(model: ModelAPI):
    """The train state on the meta device: shapes and dtypes only."""
    params = model.abstract_params()
    return {"params": params, "opt": opt_lib.init_state(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def train_state_specs(model: ModelAPI):
    """Logical-axis tree matching the train state (the parameters in the
    reference's grouped layout)."""
    pspecs = model.param_specs()
    return {"params": pspecs,
            "opt": {"mu": pspecs, "nu": pspecs, "count": ()},
            "step": ()}


def make_train_step(model: ModelAPI, tc: TrainConfig):
    """Returns fn(state, batch) -> (state, metrics); the state is updated
    in place (the reference donates it).

    microbatches > 1 splits the batch's leading axis and accumulates
    float32 gradients over the splits in order (the reference's scan); the
    metrics then carry only loss, grad_norm and lr, as the reference's.
    """

    def grads_of(params, batch):
        names, masters = zip(*params.named_parameters())
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in masters]
            loss, m = _loss_fn(model, tc, dict(zip(names, leaves)), batch)
            grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in m.items()},
                dict(zip(names, grads)))

    def step(state, batch):
        params = state["params"]
        if tc.microbatches > 1:
            k = tc.microbatches

            def split(x):
                return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))

            mb = {name: split(x) for name, x in batch.items()}
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.named_parameters()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=gsum[next(iter(gsum))].device)
            for i in range(k):
                loss, _, g = grads_of(params, {n: x[i]
                                               for n, x in mb.items()})
                for n, gi in g.items():
                    gsum[n].add_(gi.to(torch.float32))
                loss_sum = loss_sum + loss
                del g
            grads = {n: g.div_(k) for n, g in gsum.items()}
            loss = loss_sum / k
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        params, opt, om = opt_lib.apply_updates(tc.optimizer, params, grads,
                                                state["opt"])
        out = {"loss": loss, **metrics, **om}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, out

    return step


def make_eval_step(model: ModelAPI, tc: TrainConfig):
    @torch.no_grad()
    def step(params, batch):
        loss, m = _loss_fn(model, tc, params, batch)
        return {"loss": loss, **m}
    return step
