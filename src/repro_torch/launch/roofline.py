"""Roofline terms of one call on the card (port of
``repro.launch.roofline``).

Hardware model: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W limit):

  compute_s    = FLOPs / 989e12        (bf16 tensor-core peak)
  memory_s     = bytes accessed / 3.35e12   (HBM3)
  collective_s = collective wire bytes / 450e9   (NVLink 4, one direction)

The reference reads FLOPs, bytes and collective bytes from a compiled
XLA executable and its partitioned HLO text.  Eager PyTorch has no such
graph, so ``analyze`` runs the function once instead: FLOPs from
``torch.utils.flop_counter.FlopCounterMode``, collective bytes from the
port's own all-reduce counter (``engine.collective_counter``), and peak
memory from the CUDA allocator.  The bytes accessed are the caller's, as
the bounds in ``PERF.md`` count them (each input read once, each output
written once): nothing in torch reads them from a graph.  The HLO-text
parser (``collective_bytes``) has no counterpart here.

Collective wire model (ring all-reduce): 2·(n-1)/n · payload, taken as
2 · payload.
"""
from __future__ import annotations

import dataclasses

import torch

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


def analyze(fn, *args, bytes_accessed: float = 0.0, device=None,
            **kwargs) -> Roofline:
    """Run ``fn(*args, **kwargs)`` once and read its roofline terms.

    ``device`` (``None`` means CUDA): where the peak memory is read; on
    the card the allocator's peak is reset before the call and read after
    it, on the CPU it is 0.  The collective counter is read as a
    difference, so calls made before this one do not count."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import engine
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = engine.collective_counter()
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    after = engine.collective_counter()
    peak = 0
    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    payload = after["bytes"] - before["bytes"]
    breakdown = ({"all-reduce": 2.0 * payload}        # the ring's wire bytes
                 if after["calls"] > before["calls"] else {})
    return Roofline(flops=float(counter.get_total_flops()),
                    bytes_accessed=float(bytes_accessed),
                    coll_bytes=sum(breakdown.values()),
                    coll_breakdown=breakdown, peak_memory=int(peak))


def model_flops(cfg, shape, n_tokens: int) -> float:
    """Useful-model FLOPs for the step: 6·N·D train, 2·N·D decode/prefill
    (N = active params)."""
    n_active = cfg.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * n_tokens
