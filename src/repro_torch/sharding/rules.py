"""Logical-axis → mesh-axis sharding rules as DTensor placements (port of
``repro.sharding.rules``).

Model code annotates every parameter and state leaf with logical axis
names (tuples like ("embed", "q_heads", "head_dim")); this module maps
them to a per-dimension spec for a ``DeviceMesh`` and from there to DTensor
placements.  Strategy (MaxText-style):

  * tensor-parallel axes (heads/mlp/vocab/experts) → "model"
  * FSDP: the d_model ("embed") weight axis → "data" (the optimizer
    state inherits it → ZeRO-3)
  * batch → all data-parallel axes ("pod", "data")
  * long-context decode (batch=1): kv_seq → "data"

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of mesh axis names (the
dimension split over several mesh axes, the first the major one), as a
JAX ``PartitionSpec`` reads.  A mesh axis appears at most once in a spec;
when two logical axes map to the same mesh axis, the later one is dropped
(replicated), e.g. zamba's (embed, embed) projections.  A mapping whose
dimension does not divide its mesh axes is dropped too, so DTensor's
uneven sharding is never reached.

``constrain`` is the reference's activation constraint: it redistributes
a DTensor to its logical layout under the ambient mesh
(``repro_torch.launch.mesh.use_mesh``) and returns its argument unchanged
without one.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading

import torch
from torch import nn

# logical axis -> mesh axis (None = replicate)
BASE_RULES: dict[str, str | tuple[str, ...] | None] = {
    "layers": None,
    "embed": ("pod", "data"),  # FSDP; extends across pods when present
    "heads_embed": "model",    # square d×d projections' output side (rwkv)
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    # projection input dims that stay replicated (sharding the contraction
    # dim of a small model's projections over the data axis makes the
    # partitioner reduce whole activations instead of gathering the weight)
    "act_in": None,
    # the embedding table's d_model axis stays replicated: sharding it puts
    # the contraction dim of the tied LM head on the data axis
    "table_embed": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "conv": None,
    "state": None,
    "lora": None,
    "heads": "model",
    # activations / cache
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
}

# decode: the cache is written in place each step, so its kv_seq dim stays
# unsharded; kv_heads shard over "model" instead, with head_dim as the
# dedupe fallback when the heads do not divide (qwen's 20 kv heads on a
# 16-way model axis shard head_dim = 128)
DECODE_OVERRIDES = {
    "kv_seq": None,
    "head_dim": "model",
}

LONG_CONTEXT_OVERRIDES = {
    "batch": None,                    # batch=1: cannot shard
    "kv_seq": ("data", "model"),      # shard the long KV/sequence instead
}


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[_axis_names(mesh).index(name)]


def _mesh_axes(mesh, name) -> tuple[str, ...]:
    if name is None:
        return ()
    names = name if isinstance(name, tuple) else (name,)
    return tuple(n for n in names if n in _axis_names(mesh))


def spec_for(mesh, logical: tuple, rules: dict | None = None,
             dims: tuple[int, ...] | None = None) -> tuple:
    """The per-dimension spec of the logical axes ``logical``; repeated mesh
    axes are deduplicated (the later use replicated).  With ``dims``, a
    mapping whose dimension does not divide its mesh axes is dropped.
    ``mesh`` is a ``DeviceMesh`` or anything with its ``mesh_dim_names``
    and ``shape``."""
    rules = rules or BASE_RULES
    used: set[str] = set()
    out = []
    for i, ax in enumerate(logical):
        mapped = _mesh_axes(mesh, rules.get(ax) if ax is not None else None)
        mapped = tuple(m for m in mapped if m not in used)
        if mapped and dims is not None:
            total = 1
            for m in mapped:
                total *= _axis_size(mesh, m)
            if dims[i] % total:
                mapped = ()
        if mapped:
            used.update(mapped)
            out.append(mapped if len(mapped) > 1 else mapped[0])
        else:
            out.append(None)
    return tuple(out)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on every
    mesh dimension that tensor dimension ``i`` is split over, ``Replicate``
    on the others.  A dimension split over several mesh axes is split major
    to minor in the mesh's own order, as JAX splits it; a spec that names
    them in another order, or names an axis twice, is refused."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    out: list = [Replicate()] * len(names)
    seen: set[str] = set()
    for i, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or seen & set(axes):
            raise ValueError(f"spec {spec} cannot be placed on mesh axes "
                             f"{names}: tensor dim {i} names {axes}")
        seen.update(axes)
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``):
    ``placements`` are what ``distribute_tensor`` takes."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def distribute(self, t: torch.Tensor):
        """``t`` (the whole tensor, the same on every rank) as a DTensor:
        each rank keeps its own block, with no communication.  A block
        that is a part of ``t`` is copied into a storage of its own, so
        that ``t`` is freed with its last other reference."""
        from torch.distributed.tensor import distribute_tensor
        out = distribute_tensor(t, self.mesh, self.placements,
                                src_data_rank=None)
        local = out.to_local()
        if local.untyped_storage().nbytes() > (local.numel()
                                               * local.element_size()):
            out = dtensor_of(local.clone(), self.mesh, self.placements,
                             t.shape)
        return out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _resolve(spec_tree, name: str) -> tuple[tuple, int]:
    """The logical axes of the parameter ``name`` (dotted, as
    ``named_parameters`` gives it) in the reference-layout ``spec_tree``,
    and how many of its leading axes the port's tensor lacks.  A numeric
    part is an index into a module list: against a tuple of layer groups
    (the transformer's ``layers``) it picks group ``i % g``, against a
    stacked subtree it takes nothing; either way the reference's leaf has
    one more leading (stacking) axis than the port's tensor."""
    node, lead = spec_tree, 0
    for part in name.split("."):
        if part.isdigit():
            if isinstance(node, tuple) and not _is_spec(node):
                node = node[int(part) % len(node)]
            lead += 1
        else:
            node = node[part]
    if not _is_spec(node):
        raise KeyError(f"{name!r} is no leaf of the spec tree")
    return node, lead


def _leaf_sharding(mesh, logical, lead, shape, rules, name):
    full_dims = None if shape is None else (1,) * lead + tuple(shape)
    spec = spec_for(mesh, logical, rules, dims=full_dims)
    if any(e is not None for e in spec[:lead]):
        raise ValueError(f"{name}: the stacking axes {logical[:lead]} map to "
                         f"mesh axes {spec[:lead]}; the port keeps them as "
                         f"module lists, which cannot be sharded")
    if shape is not None and len(spec) - lead != len(shape):
        raise ValueError(f"{name}: logical axes {logical} against shape "
                         f"{tuple(shape)}")
    return NamedSharding(mesh, spec[lead:])


def tree_shardings(mesh, spec_tree, shape_tree=None, *,
                   overrides: dict | None = None):
    """Map a logical-spec tree in the reference's layout to a
    ``NamedSharding`` tree in the layout of ``shape_tree``, the port's
    state (its divisibility checks use its shapes).

    ``shape_tree`` may hold: an ``nn.Module`` (→ a dict of its parameter
    names), a dict keyed by parameter names (the AdamW moments), a dict of
    subtrees matched key by key, tensors (→ one sharding) and host scalars
    (→ None).  Without ``shape_tree`` the result has ``spec_tree``'s
    layout and no divisibility check.
    """
    rules = dict(BASE_RULES)
    if overrides:
        rules.update(overrides)

    def ref_layout(spec):
        if _is_spec(spec):
            return NamedSharding(mesh, spec_for(mesh, spec, rules))
        if isinstance(spec, dict):
            return {k: ref_layout(v) for k, v in spec.items()}
        return type(spec)(ref_layout(v) for v in spec)

    if shape_tree is None:
        return ref_layout(spec_tree)

    def by_name(spec, named):
        out = {}
        for n, t in named:
            logical, lead = _resolve(spec, n)
            out[n] = _leaf_sharding(mesh, logical, lead, t.shape, rules, n)
        return out

    def walk(spec, shape, path):
        if isinstance(shape, nn.Module):
            return by_name(spec, shape.named_parameters())
        if isinstance(shape, torch.Tensor):
            if not _is_spec(spec):
                raise ValueError(f"{path}: a tensor against {spec!r}")
            return _leaf_sharding(mesh, spec, 0, shape.shape, rules, path)
        if isinstance(shape, dict):
            if isinstance(spec, dict) and set(shape) <= set(spec):
                return {k: walk(spec[k], v, f"{path}/{k}")
                        for k, v in shape.items()}
            return by_name(spec, shape.items())
        if isinstance(shape, (list, tuple)):
            return type(shape)(walk(s, v, f"{path}/{i}") for i, (s, v) in
                               enumerate(zip(spec, shape)))
        return None                         # a host scalar (``len``)

    return walk(spec_tree, shape_tree, "")


def distribute_tree(tree, shardings):
    """``tree`` with every leaf that ``shardings`` gives a ``NamedSharding``
    made a DTensor (the counterpart of ``jax.device_put(tree, shardings)``):
    a module's parameters are replaced in place by parameters holding
    DTensors; dicts and lists are rebuilt; a leaf whose sharding is None
    (a host scalar) is kept.  Each rank passes the whole tensors, the same
    on every rank, and keeps its own blocks."""
    if isinstance(tree, nn.Module):
        for n, p in list(tree.named_parameters()):
            mod, _, leaf = n.rpartition(".")
            setattr(tree.get_submodule(mod), leaf, nn.Parameter(
                shardings[n].distribute(p.detach()),
                requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, torch.Tensor):
        return tree if shardings is None else shardings.distribute(tree)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s)
                          for v, s in zip(tree, shardings))
    return tree


def dtensor_of(local, mesh, placements, shape):
    """``local``, this rank's block, as a DTensor of the global ``shape``
    (contiguous) laid out by ``placements``: each rank passes its own
    block, and nothing is checked or moved."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def mesh_of(tree):
    """The mesh of the first DTensor leaf of ``tree``, or None."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, DTensor):
        return tree.device_mesh
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            mesh = mesh_of(v)
            if mesh is not None:
                return mesh
    return None


def constrain(x, *logical, overrides: dict | None = None, dims=None):
    """Activation sharding constraint by logical axis names: ``x`` laid out
    as ``logical`` says on the ambient mesh (a mapping whose dimension does
    not divide its mesh axes is dropped).  Without an ambient mesh ``x`` is
    returned as it is.  A plain tensor under a mesh is taken as replicated
    (what ``implicit_replication`` does with it) and then laid out.
    ``dims`` (default ``x.shape``) are the sizes the divisibility test
    reads, for a layout that must survive a later reshape."""
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if len(logical) != x.ndim:
        raise ValueError(f"constrain: {len(logical)} logical axes for a "
                         f"tensor of {x.ndim} dims")
    rules = dict(BASE_RULES)
    if overrides:
        rules.update(overrides)
    want = placements(mesh, spec_for(mesh, logical, rules,
                                     dims=x.shape if dims is None else dims))
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return _Constrain.apply(x, mesh, want, _caller_site())


def relayout(x, placements):
    """The DTensor ``x`` laid out by DTensor ``placements`` on its own mesh,
    as ``constrain`` lays it out by logical axes (in both directions, and
    booked to the caller's site): for a layout read off another tensor, as
    attention takes its K/V cache's.  A ``Partial`` input is reduced by
    the move."""
    return _Constrain.apply(x, x.device_mesh, tuple(placements),
                            _caller_site())


def _caller_site() -> str:
    """``file:function`` of the caller of ``constrain``/``relayout``."""
    caller = sys._getframe(2)
    return (f"{os.path.basename(caller.f_code.co_filename)}:"
            f"{caller.f_code.co_name}")


_SITE = threading.local()


def current_site() -> str | None:
    """The ``constrain`` call site (``file:function``, "(grad)" in the
    backward) whose redistribute is running, or None: the dry run books
    each collective to the site that issued it."""
    return getattr(_SITE, "name", None)


def _redistribute(x, mesh, want, site):
    _SITE.name = site
    try:
        return x.redistribute(mesh, want)
    finally:
        _SITE.name = None


def constrain_state(state, specs):
    """A decode state made inside a model, laid out under the ambient mesh
    by its logical ``specs`` (``decode_state_specs()``) and the ambient
    ``state_overrides`` (default ``DECODE_OVERRIDES``): what the reference's
    prefill cells give its out-shardings.  Without a mesh ``state`` is
    returned as it is; host scalars (``len``) are kept."""
    from repro_torch.launch.mesh import current_mesh, current_state_overrides
    if current_mesh() is None:
        return state
    over = current_state_overrides()
    over = DECODE_OVERRIDES if over is None else over

    def walk(s, spec):
        if isinstance(s, torch.Tensor):
            return constrain(s, *spec, overrides=over)
        if isinstance(s, dict):
            return {k: walk(v, spec[k]) for k, v in s.items()}
        return s
    return walk(state, specs)


class _Constrain(torch.autograd.Function):
    """The layout ``want`` in both directions, as JAX's sharding constraint
    (whose transpose constrains the cotangent alike): the forward
    redistributes the value, the backward the gradient, whatever layout
    the ops after the constraint gave it."""

    @staticmethod
    def forward(ctx, x, mesh, want, site):
        ctx.mesh, ctx.want, ctx.site = mesh, want, site
        if tuple(x.placements) == want:
            return x.view_as(x)
        return _redistribute(x, mesh, want, site)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = _redistribute(g, ctx.mesh, ctx.want, f"{ctx.site} (grad)")
        # contiguous: a gather along an inner dim, or a transposing op
        # after the constraint, leaves the local block strided, and the
        # backward of a view before the constraint cannot read it
        return g.contiguous(), None, None, None


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def batch_sharding(mesh) -> NamedSharding:
    """The leading (batch) axis over every data-parallel axis."""
    return NamedSharding(mesh, (data_axes(mesh),))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
