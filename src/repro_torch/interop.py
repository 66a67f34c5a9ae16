"""Carry state across from the JAX reference package, and back.

The reference's ``Moments``, ``Domain``, ``Polynomial``, ``FitSpec``,
``ServicePolicy`` and ``StreamState`` are read by their field names, with every array taken through
``numpy.asarray``: this module never imports the reference.  The tests feed
the reference's state through it so that both packages solve the same
thing, and start both from the same stream state.  ``model_params`` and
``decode_state`` carry a zoo model's parameter tree and KV cache the same
way, so both packages run one model from one cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.spec import (FitSpec, IRLSOptions, LSPIAOptions,
                                  ServicePolicy)
from repro_torch.core.basis import Domain
from repro_torch.core.fit import Polynomial
from repro_torch.core.moments import Moments
from repro_torch.core.streaming import StreamState
from repro_torch.device import resolve_device
from repro_torch.engine.plan import NumericsPolicy
from repro_torch.select.sweep import DegreeSearch
from repro_torch.models import transformer

MOMENT_FIELDS = ("gram", "vty", "yty", "count", "weight_sum")


def tensor(a, device=None) -> torch.Tensor:
    """A numpy-convertible array as a tensor of the same dtype."""
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def _leaf(a, device) -> torch.Tensor:
    """An array leaf as a tensor of its dtype (bfloat16 goes through
    float32, which holds it exactly: numpy has no bfloat16 of torch's)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return tensor(a.astype(np.float32), device).to(torch.bfloat16)
    return tensor(a, device)


def torch_dtype(dtype):
    """A numpy/JAX dtype (or its name) as the torch dtype; None stays None."""
    if dtype is None:
        return None
    return getattr(torch, np.dtype(dtype).name)


def moments(ref, device=None) -> Moments:
    return Moments(*(tensor(getattr(ref, f), device) for f in MOMENT_FIELDS))


def domain(ref, device=None) -> Domain:
    return Domain(tensor(ref.shift, device), tensor(ref.scale, device))


def polynomial(ref, device=None) -> Polynomial:
    """The reference Polynomial's coefficients, domain and basis (its
    diagnostics are the solve's, recomputed by the port's own solve)."""
    return Polynomial(coeffs=tensor(ref.coeffs, device),
                      domain_shift=tensor(ref.domain_shift, device),
                      domain_scale=tensor(ref.domain_scale, device),
                      basis=ref.basis)


def fit_spec(ref) -> FitSpec:
    """The reference FitSpec's fields as the port's FitSpec (a reference
    DegreeSearch becomes the port's, field by field)."""
    pol = ref.numerics
    degree = ref.degree
    if hasattr(degree, "max_degree"):
        degree = DegreeSearch(**{f.name: getattr(degree, f.name)
                                 for f in dataclasses.fields(DegreeSearch)})
    numerics = NumericsPolicy(
        accum_dtype=torch_dtype(pol.accum_dtype), compensated=pol.compensated,
        normalize=pol.normalize, solver=pol.solver, fallback=pol.fallback,
        cond_cap=pol.cond_cap)
    return FitSpec(
        degree=degree, basis=ref.basis, method=ref.method,
        irls=IRLSOptions(**{f.name: getattr(ref.irls, f.name)
                            for f in dataclasses.fields(IRLSOptions)}),
        lspia=LSPIAOptions(**{f.name: getattr(ref.lspia, f.name)
                              for f in dataclasses.fields(LSPIAOptions)}),
        domain=ref.domain, numerics=numerics, decay=ref.decay,
        ridge=ref.ridge, engine=ref.engine)


def service_policy(ref) -> ServicePolicy:
    """The reference ServicePolicy's fields as the port's (validated
    again by the port's own checks)."""
    return ServicePolicy(**{f.name: getattr(ref, f.name)
                            for f in dataclasses.fields(ServicePolicy)})


def stream_state(ref_or_snapshot, *, spec=None, device=None) -> StreamState:
    """A reference ``StreamState``, or its ``snapshot()`` dict, as the
    port's.  ``spec`` (a port FitSpec) defaults to the reference state's
    own spec carried across; a snapshot carries none."""
    snap = ref_or_snapshot
    if not isinstance(snap, dict):
        if spec is None and getattr(snap, "spec", None) is not None:
            spec = fit_spec(snap.spec)
        snap = snap.snapshot()
    return StreamState.restore(snap, spec=spec, device=device)


def to_numpy(obj) -> dict:
    """A port dataclass (Moments, Domain, Polynomial, ...) as a dict of its
    fields, tensors as numpy arrays (nested dataclasses recursively)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        elif dataclasses.is_dataclass(v):
            v = to_numpy(v)
        out[f.name] = v
    return out


def model_params(ref_tree, cfg, device=None):
    """A reference transformer parameter tree (``layers`` a tuple of ``g``
    stacks with a leading ``n_groups`` axis) as the port's model: layer
    ``i`` is slot ``i % g`` of group ``i // g``."""
    dev = resolve_device(device)
    g = transformer.group_size(cfg)
    model = transformer.Transformer(cfg, device="meta")

    def assign(mod, tree, pick):
        for name, sub in tree.items():
            if isinstance(sub, dict):
                assign(getattr(mod, name), sub, pick)
            else:
                setattr(mod, name, torch.nn.Parameter(
                    _leaf(pick(np.asarray(sub)), dev), requires_grad=False))

    assign(model.embed, ref_tree["embed"], lambda a: a)
    assign(model.final_norm, ref_tree["final_norm"], lambda a: a)
    for i, layer in enumerate(model.layers):
        assign(layer, ref_tree["layers"][i % g], lambda a, i=i: a[i // g])
    left = [n for n, p in model.named_parameters() if p.device.type == "meta"]
    if left:
        raise ValueError(f"the reference tree has no {left}")
    return model


def decode_state(ref_state, cfg, device=None) -> dict:
    """A reference decode state (grouped cache stacks, ``len`` a scalar) as
    the port's: ``k``/``v`` of (n_layers, batch, max_len, kv_heads,
    head_dim) in layer order, ``len`` a host int."""
    dev = resolve_device(device)
    g = transformer.group_size(cfg)
    layers = ref_state["layers"]

    def stack(key):
        return torch.stack([_leaf(np.asarray(layers[i % g][key])[i // g], dev)
                            for i in range(cfg.n_layers)])

    return {"k": stack("k"), "v": stack("v"),
            "len": int(np.asarray(ref_state["len"]))}
