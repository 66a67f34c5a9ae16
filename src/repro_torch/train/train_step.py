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
from repro_torch.launch.mesh import use_mesh
from repro_torch.models import common as cm
from repro_torch.models.registry import ModelAPI
from repro_torch.models.transformer import torch_dtype
from repro_torch.sharding import rules
from repro_torch.sharding.rules import constrain
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt_lib.AdamWConfig = opt_lib.AdamWConfig()
    microbatches: int = 1          # grad accumulation splits of the batch
    z_loss: float = 1e-4
    aux_loss_weight: float = 1e-2  # MoE load-balance loss


def cross_entropy(logits, labels, loss_mask):
    """logits (B,S,V) any float dtype; labels (B,S) int; mask (B,S).
    Returns (mean masked NLL, mean masked logsumexp²), float32.  Under a
    mesh the logits are gathered whole over the vocab first: DTensor has no
    sharding strategy for the gold-label gather on a sharded vocab; the
    gold logits are then taken on each rank's own rows."""
    from torch.distributed.tensor import DTensor
    logits = constrain(logits, "batch", None, None).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        gold = _gold_on_local_rows(logits, labels)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    mask = loss_mask.to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll * mask) / denom, torch.sum(lse * lse * mask) / denom


def _gold_on_local_rows(logits, labels):
    """The gold logits of the DTensor ``logits`` (its vocab whole), taken
    on each rank's own rows with its rows of ``labels`` (sliced from a
    replicated or plain ``labels``): DTensor's gather runs its backward at
    the global batch, zeros of every rank's rows on each rank.  Each
    rank's rows are its own, so the local gradient is its block's."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = logits.device_mesh
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    labels = rules.relayout(labels, logits.placements)
    gold = torch.gather(logits.to_local(), -1,
                        labels.to_local().long()[..., None])[..., 0]
    return rules.dtensor_of(gold, mesh, logits.placements,
                            tuple(logits.shape[:-1]))


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


def init_train_state(model: ModelAPI, rng=0, device=None, *, mesh=None,
                     shardings=None):
    """``rng``: an int seed or a ``torch.Generator`` on ``device``
    (``None`` means CUDA).

    With ``mesh`` every leaf is a DTensor laid out by ``shardings``
    (default: ``train_state_specs`` through ``rules.tree_shardings``).  The
    parameters are drawn from the seed on every rank as without a mesh,
    leaf by leaf, each rank keeping its block of a leaf before the next is
    drawn, so a sharded run starts from the bits of a single-process one
    and a rank holds at most its share of the state and one leaf drawn
    whole; the AdamW moments take the parameters' placements, ``count``
    and ``step`` are replicated."""
    dtype = torch_dtype(model.cfg.param_dtype)
    dev = resolve_device(device)
    if mesh is not None:
        return _init_on_mesh(model, rng, dtype, dev, mesh, shardings)
    return _state_of(model.init_params(rng, dtype=dtype, device=dev))


def _init_on_mesh(model: ModelAPI, rng, dtype, device, mesh, shardings):
    """``init_train_state(mesh=)``: the model is made once on the meta
    device to learn the order in which it makes its leaves and their
    names, then made for real with each leaf replaced, as soon as it is
    drawn, by this rank's block of it (``common.leaf_hook``)."""
    made = []
    with cm.leaf_hook(lambda p: made.append(p) or p):
        abstract = model.abstract_params()
    names = {id(p): n for n, p in abstract.named_parameters()}
    order = iter([(names[id(p)], tuple(p.shape)) for p in made])
    if shardings is None:
        shardings = rules.tree_shardings(mesh, train_state_specs(model),
                                         _state_of(abstract))
    psh = shardings["params"]

    def place(p):
        name, shape = next(order)
        if tuple(p.shape) != shape:
            raise ValueError(f"leaf {name}: drawn {tuple(p.shape)}, "
                             f"made on the meta device as {shape}")
        return nn.Parameter(psh[name].distribute(p.detach()),
                            requires_grad=False)

    with cm.leaf_hook(place):
        params = model.init_params(rng, dtype=dtype, device=device)
    if next(order, None) is not None:
        raise ValueError("the model made fewer leaves than on the meta "
                         "device")
    state = _state_of(params)          # mu and nu: zeros of local blocks
    state["opt"]["count"] = shardings["opt"]["count"].distribute(
        state["opt"]["count"])
    state["step"] = shardings["step"].distribute(state["step"])
    return state


def _state_of(params):
    """The train state around ``params`` (zero moments like them)."""
    dev = next(params.parameters()).device
    return {"params": params, "opt": opt_lib.init_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_shardings(model: ModelAPI, mesh, state=None, *, overrides=None):
    """The ``NamedSharding`` tree of a train state on ``mesh`` (of
    ``state``, or of the abstract state), in the port's layout."""
    return rules.tree_shardings(
        mesh, train_state_specs(model),
        abstract_train_state(model) if state is None else state,
        overrides=overrides)


def shard_batch(batch: dict, mesh, microbatches: int = 1) -> dict:
    """The global batch (the same whole tensors on every rank) as DTensors
    whose leading axis is split over the mesh's data axes.  Each rank's
    block is ordered so that its ``microbatches`` consecutive slices, the
    ones the train step takes, are its parts of the reference's
    contiguous microbatches: global microbatch ``i`` (rows ``i·B/k`` to
    ``(i+1)·B/k``) is then slice ``i`` of every rank.  A leaf whose batch
    does not divide ``k`` times the data ranks is replicated."""
    axes = rules.data_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    n, d = 1, 0
    for a in axes:                    # this rank's row-major data index
        i = names.index(a)
        n *= mesh.size(i)
        d = d * mesh.size(i) + mesh.get_local_rank(i)
    k = microbatches
    out = {}
    for key, x in batch.items():
        b = x.shape[0]
        if b % (n * k):
            out[key] = rules.replicated(mesh).distribute(x)
            continue
        rows = x.reshape((k, n, b // (n * k)) + tuple(x.shape[1:]))[:, d]
        local = rows.reshape((b // n,) + tuple(x.shape[1:]))
        out[key] = rules.dtensor_of(
            local, mesh,
            rules.placements(mesh, (axes,) + (None,) * (x.ndim - 1)),
            x.shape)
    return out


def abstract_train_state(model: ModelAPI):
    """The train state on the meta device: shapes and dtypes only."""
    return _state_of(model.abstract_params())


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

    A state of DTensors (``init_train_state(..., mesh=)``) runs on its
    mesh: the step makes it the ambient mesh (the models' ``constrain``
    points read it) and takes plain tensors as replicated.  Each gradient
    is redistributed to its parameter's placements, and a batch of
    DTensors (``shard_batch``) is split into microbatches rank by rank,
    each rank's block keeping its placements.
    """

    def grads_of(params, batch):
        names, masters = zip(*params.named_parameters())
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in masters]
            loss, m = _loss_fn(model, tc, dict(zip(names, leaves)), batch)
            grads = torch.autograd.grad(loss, leaves)
        grads = [_like(g, p) for g, p in zip(grads, leaves)]
        return (loss.detach(), {k: v.detach() for k, v in m.items()},
                dict(zip(names, grads)))

    def step(state, batch):
        params = state["params"]
        if tc.microbatches > 1:
            k = tc.microbatches

            mb = {name: _split(x, k) for name, x in batch.items()}
            gsum = {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.named_parameters()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=next(iter(gsum.values())).device)
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

    def run(state, batch):
        mesh = rules.mesh_of(state["params"])
        if mesh is None:
            return step(state, batch)
        from torch.distributed.tensor.experimental import implicit_replication
        with use_mesh(mesh), implicit_replication():
            return step(state, batch)

    return run


def _like(g, p):
    """The gradient ``g`` in the placements of its parameter ``p``."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _split(x, k):
    """``x``'s leading axis as ``k`` microbatches: a list of ``k`` tensors
    (a DTensor: each rank's block split, the placements kept)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        local = x.to_local()
        rows = local.shape[0] // k
        shape = (x.shape[0] // k,) + tuple(x.shape[1:])
        return [rules.dtensor_of(local[i * rows:(i + 1) * rows],
                                 x.device_mesh, x.placements, shape)
                for i in range(k)]
    return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))


def make_eval_step(model: ModelAPI, tc: TrainConfig):
    @torch.no_grad()
    def step(params, batch):
        loss, m = _loss_fn(model, tc, params, batch)
        return {"loss": loss, **m}
    return step
