"""Roofline terms of one call on the card (port of
``repro.launch.roofline``).

Hardware model: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W limit):

  compute_s    = FLOPs / 989e12        (bf16 tensor-core peak)
  memory_s     = bytes accessed / 3.35e12   (HBM3)
  collective_s = collective wire bytes / 450e9   (NVLink 4, one direction)

The reference reads FLOPs, bytes and collective bytes from a compiled
XLA executable and its partitioned HLO text.  Eager PyTorch has no such
graph, so ``analyze`` runs the function once instead under ``CostCounter``,
a dispatch mode that sees every op this rank runs: FLOPs by
``torch.utils.flop_counter``'s formulas, collective bytes by kind from the
traced ``_c10d_functional`` and ``c10d`` ops (``collective_bytes``), and,
on request, the bytes of the storages the ops create.  On a DTensor it
counts the local ops each rank runs, so the counts are per rank.  Peak
memory comes from the CUDA allocator.  The bytes accessed are the
caller's, as the bounds in ``PERF.md`` count them (each input read once,
each output written once): nothing in torch reads them from a graph.

Collective wire model per op (ring algorithm), on the op's result bytes
as the reference reads them from HLO:
  all-reduce        2·(n-1)/n · bytes  ≈ 2·bytes
  all-gather        (n-1)/n · out_bytes ≈ out_bytes
  reduce-scatter    (n-1)/n · in_bytes  ≈ out_bytes (the reference's
                    HLO shape is the result's)
  all-to-all        (n-1)/n · bytes     ≈ bytes
  broadcast         bytes
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12             # bytes/s, H100 SXM HBM3 data sheet
NVLINK_BW = 450e9            # bytes/s per direction, NVLink 4 (H100 SXM)


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes: float            # per device (wire model)
    coll_breakdown: dict
    peak_memory: int             # per device, bytes

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def summary(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "coll_bytes_per_dev": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
            "peak_memory_gb": self.peak_memory / 1e9,
            "coll_breakdown": self.coll_breakdown,
        }


# collective op name (namespace.name, overload dropped) -> kind
_COLLECTIVE_KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "broadcast",
}
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "broadcast": 1.0}
_PROPAGATING = threading.local()


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def collective_bytes(func, out) -> tuple[str, float] | None:
    """(kind, per-rank wire bytes) of one traced collective op, or None for
    any other op.  The wire bytes follow the reference's model on the op's
    result (a c10d op returns its output tensors, which it wrote in
    place)."""
    name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
    kind = _COLLECTIVE_KINDS.get(name)
    if kind is None:
        return None
    return kind, _WIRE_FACTOR[kind] * _nbytes(out)


class CostCounter(TorchDispatchMode):
    """Per-rank costs of the ops run inside it: ``flops`` (by
    ``torch.utils.flop_counter``'s formulas), ``coll`` (wire bytes by
    collective kind; ``coll_by_site`` by the ``constrain`` call that
    issued them), ``op_bytes`` (each op that is no view, allocation or
    collective reads its tensor inputs and writes its outputs once: an
    unfused upper bound on memory traffic) and, with ``track_memory``,
    ``peak_bytes``: the most bytes held at once by storages the ops
    created (views, in-place results and meta tensors add nothing; a
    storage counts until it is freed).

    On a DTensor op the mode steps aside, so it counts the local ops the
    DTensor runs on this rank's blocks; the global-shape ops DTensor runs
    on fake tensors to work out its output's metadata are not counted.
    Under ``FakeTensorMode`` the storages are fake, so the peak is that of
    the eager op order (an estimate of a real run's allocator peak)."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.coll: dict[str, float] = {}
        # wire bytes by the ``sharding.constrain`` site that issued them;
        # "implicit" for DTensor's own redistributes inside an op
        self.coll_by_site: dict[str, float] = {}
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()
        self._patch = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, schema):
            _PROPAGATING.on = getattr(_PROPAGATING, "on", 0) + 1
            try:
                return orig(prop, schema)
            finally:
                _PROPAGATING.on -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._patch = (ShardingPropagator, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._patch
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    def _free(self, nbytes):
        self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "on", 0):
            return out
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        coll = collective_bytes(func, out)
        if coll is not None:
            from repro_torch.sharding.rules import current_site
            self.coll[coll[0]] = self.coll.get(coll[0], 0.0) + coll[1]
            site = current_site() or "implicit"
            self.coll_by_site[site] = (self.coll_by_site.get(site, 0.0)
                                       + coll[1])
        elif not (func.is_view or func.namespace != "aten"
                  or func.__name__.startswith("empty")):
            self.op_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        if self.track_memory:
            for t in _tensors(out):
                if t.device.type == "meta":         # holds no memory
                    continue
                st = t.untyped_storage()
                if st in self._seen:
                    continue
                self._seen.add(st)
                n = st.nbytes()
                self.live_bytes += n
                weakref.finalize(st, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


def analyze(fn, *args, bytes_accessed: float = 0.0, device=None,
            **kwargs) -> Roofline:
    """Run ``fn(*args, **kwargs)`` once and read its roofline terms.

    ``device`` (``None`` means CUDA): where the peak memory is read; on
    the card the allocator's peak is reset before the call and read after
    it, on the CPU it is 0.  ``coll_breakdown`` holds the traced
    collectives' wire bytes by kind; where none of them is an all-reduce,
    the port's all-reduce counter (``engine.collective_counter``, read as
    a difference, so calls made before this one do not count) stands in
    for the all-reduces the trace cannot see."""
    from repro_torch import engine
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = engine.collective_counter()
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    after = engine.collective_counter()
    peak = 0
    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    breakdown = dict(counter.coll)
    payload = after["bytes"] - before["bytes"]
    if after["calls"] > before["calls"] and "all-reduce" not in breakdown:
        breakdown["all-reduce"] = 2.0 * payload   # the ring's wire bytes
    return Roofline(flops=float(counter.flops),
                    bytes_accessed=float(bytes_accessed),
                    coll_bytes=sum(breakdown.values()),
                    coll_breakdown=breakdown, peak_memory=int(peak))


def model_flops(cfg, shape, n_tokens: int) -> float:
    """Useful-model FLOPs for the step: 6·N·D train, 2·N·D decode/prefill
    (N = active params)."""
    n_active = cfg.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * n_tokens
