"""Carry state across from the JAX reference package, and back.

The reference's ``Moments``, ``Domain``, ``Polynomial``, ``FitSpec``,
``ServicePolicy`` and ``StreamState`` are read by their field names, with every array taken through
``numpy.asarray``: this module never imports the reference.  The tests feed
the reference's state through it so that both packages solve the same
thing, and start both from the same stream state.  ``model_params`` and
``decode_state`` carry a zoo model's parameter tree and decode state the
same way, so both packages run one model from one cache, and ``train_state``
carries a train state (parameters, AdamW moments, counters), so both
packages take a train step from the same numbers.
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
from repro_torch.models import encdec, rwkv6_model, transformer, zamba2

MOMENT_FIELDS = ("gram", "vty", "yty", "count", "weight_sum")
# the zoo families whose parameter and decode-state trees the port keeps
# in the reference's layout, with its stacks as module lists
_FAMILY_MODULES = {"ssm": rwkv6_model, "hybrid": zamba2, "audio": encdec}


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


def _assign(mod, tree, pick, dev):
    """The reference subtree ``tree`` as ``mod``'s parameters, each leaf
    through ``pick``; an ``nn.ModuleList`` takes element ``i`` of its
    stacked subtree's next leading axis (nested lists, the next ones)."""
    if isinstance(mod, torch.nn.ModuleList):
        for i, child in enumerate(mod):
            _assign(child, tree, lambda a, i=i: pick(a)[i], dev)
        return
    for name, sub in tree.items():
        if isinstance(sub, dict):
            _assign(getattr(mod, name), sub, pick, dev)
        else:
            setattr(mod, name, torch.nn.Parameter(
                _leaf(pick(np.asarray(sub)), dev), requires_grad=False))


def model_params(ref_tree, cfg, device=None):
    """A reference parameter tree as the port's model.  Transformers: the
    ``layers`` tuple of ``g`` stacks with a leading ``n_groups`` axis
    (layer ``i`` is slot ``i % g`` of group ``i // g``).  rwkv6, zamba2
    and whisper: each stacked subtree unstacked into its module list
    (``layers``; ``blocks`` (n_groups, attn_every), ``tail``,
    ``shared``; ``enc_layers``, ``dec_layers``)."""
    dev = resolve_device(device)
    same = lambda a: a
    if cfg.family in _FAMILY_MODULES:
        model = _FAMILY_MODULES[cfg.family].abstract_params(cfg)
        _assign(model, ref_tree, same, dev)
    else:
        g = transformer.group_size(cfg)
        model = transformer.Transformer(cfg, device="meta")
        _assign(model.embed, ref_tree["embed"], same, dev)
        _assign(model.final_norm, ref_tree["final_norm"], same, dev)
        for i, layer in enumerate(model.layers):
            _assign(layer, ref_tree["layers"][i % g],
                    lambda a, i=i: a[i // g], dev)
    left = [n for n, p in model.named_parameters() if p.device.type == "meta"]
    if left:
        raise ValueError(f"the reference tree has no {left}")
    return model


def decode_state(ref_state, cfg, device=None) -> dict:
    """A reference decode state (``len`` a scalar) as the port's, ``len`` a
    host int.  Transformers: the grouped cache stacks as ``k``/``v`` of
    (n_layers, batch, max_len, kv_heads, head_dim) in layer order.  rwkv6,
    zamba2 and whisper keep the reference's tree, leaf for leaf."""
    dev = resolve_device(device)
    length = int(np.asarray(ref_state["len"]))
    if cfg.family in _FAMILY_MODULES:
        def tree(t):
            if isinstance(t, dict):
                return {k: tree(v) for k, v in t.items()}
            return _leaf(t, dev)
        return dict(tree({k: v for k, v in ref_state.items()
                          if k != "len"}), len=length)
    g = transformer.group_size(cfg)
    layers = ref_state["layers"]

    def stack(key):
        return torch.stack([_leaf(np.asarray(layers[i % g][key])[i // g], dev)
                            for i in range(cfg.n_layers)])

    return {"k": stack("k"), "v": stack("v"), "len": length}


def train_state(ref_state, cfg, device=None) -> dict:
    """A reference train state (``params``, ``opt`` with ``mu``/``nu``
    trees and ``count``, ``step``) as the port's: the parameters as the
    model (``model_params``), ``mu``/``nu`` by the same mapping as dicts
    keyed by its parameter names, ``count``/``step`` int32 scalars."""
    dev = resolve_device(device)
    opt = ref_state["opt"]

    def moments(tree):
        return {n: p.detach() for n, p in
                model_params(tree, cfg, device=dev).named_parameters()}

    return {"params": model_params(ref_state["params"], cfg, device=dev),
            "opt": {"mu": moments(opt["mu"]), "nu": moments(opt["nu"]),
                    "count": tensor(np.asarray(opt["count"], np.int32),
                                    dev)},
            "step": tensor(np.asarray(ref_state["step"], np.int32), dev)}
