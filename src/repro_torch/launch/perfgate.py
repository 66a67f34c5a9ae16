"""Roofline-anchored performance gate (port of ``repro.launch.perfgate``).

Extends ``launch.roofline`` (the card's hardware model) with the
*dynamic* half a benchmark needs:

1. **Measured bandwidth**: a STREAM-style triad run on the given device,
   so ceilings are anchored to the machine the numbers were produced on,
   not a spec sheet.  A failed or implausible measurement raises: the
   reference falls back to its hardware model there, which would report
   the spec sheet's figure as the device's.  The model figure is only
   ever an explicit ``Bandwidth(gbps=roofline.HBM_BW / 1e9,
   source="model", ...)``.
2. **Memory-bound ceilings** for the moment/report passes.  The complexity
   analysis behind the paper (arXiv:cs/0308023) makes the moment pass
   provably memory-bound: every point is read exactly once (x, y and
   optionally w: 2 or 3 contiguous streams) against O(m²) output, so the
   floor on wall time is ``bytes_moved / bandwidth`` and the ceiling on
   throughput is ``bandwidth / bytes_per_point``.
3. **The gate**: ``check_gate`` compares one benchmark run's rows against
   a baseline of per-row budgets: a max-slowdown factor vs the stored
   reference timing, plus a roofline-fraction floor that only binds on
   rows that ran on hardware (rows marked ``interpret`` prove
   correctness, not speed; they are gated on regression only).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device

DTYPE_BYTES = 4                   # the fit stack streams f32 series

_BW_CACHE: dict[str, "Bandwidth"] = {}


@dataclasses.dataclass(frozen=True)
class Bandwidth:
    """Sustained memory bandwidth the ceilings are anchored to."""

    gbps: float                   # GB/s (1e9 bytes per second)
    source: str                   # "measured" | "model"
    backend: str                  # the device type: "cuda" | "cpu"

    @property
    def bytes_per_s(self) -> float:
        return self.gbps * 1e9


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def measure_bandwidth(*, n_mb: int = 64, reps: int = 5, iters: int = 4,
                      device=None, force: bool = False) -> Bandwidth:
    """STREAM-style triad (a = b + s·c) on ``device`` (``None`` means CUDA).

    Moves 3 arrays per call (read b, read c, write a); min-of-reps timing
    gives the *max* sustained bandwidth, the right anchor for a ceiling.
    Timed with CUDA events on a card and ``perf_counter`` on the CPU.
    Cached per device name.  Raises ``RuntimeError`` on a result outside
    (0.1, 1e5) GB/s.
    """
    dev = resolve_device(device)
    key = _device_name(dev)
    if not force and key in _BW_CACHE:
        return _BW_CACHE[key]
    n = n_mb * (1 << 20) // DTYPE_BYTES
    b = torch.arange(n, dtype=torch.float32, device=dev)
    c = torch.ones((n,), dtype=torch.float32, device=dev)
    out = torch.empty_like(b)

    def triad():
        torch.add(b, c, alpha=0.5, out=out)

    triad()                                           # warm up
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(iters):
                triad()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) * 1e-3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                triad()
            dt = (time.perf_counter() - t0) / iters
        best = min(best, dt)
    gbps = 3 * n * DTYPE_BYTES / best / 1e9
    if not 0.1 < gbps < 1e5:
        raise RuntimeError(f"implausible triad bandwidth {gbps} GB/s on "
                           f"{key}")
    bw = Bandwidth(gbps=gbps, source="measured", backend=dev.type)
    _BW_CACHE[key] = bw
    return bw


# ------------------------------------------------------------------ ceilings
def stream_bytes(n_points: int, *, streams: int = 2,
                 dtype_bytes: int = DTYPE_BYTES) -> int:
    """Bytes one single-pass accumulation must move: ``streams`` contiguous
    f32 reads per point (x, y and optionally w), O(m²) output ≈ 0."""
    if n_points < 0 or streams < 1:
        raise ValueError(f"n_points={n_points}, streams={streams}")
    return n_points * streams * dtype_bytes


def memory_s(bytes_moved: float, bandwidth: Bandwidth | float) -> float:
    """Memory-bound floor on wall time; monotone in ``bytes_moved``."""
    bps = (bandwidth.bytes_per_s if isinstance(bandwidth, Bandwidth)
           else float(bandwidth))
    if bytes_moved < 0:
        raise ValueError(f"bytes_moved={bytes_moved}")
    if bps <= 0:
        raise ValueError(f"bandwidth={bps}")
    return bytes_moved / bps


def ceiling_mpts(bandwidth: Bandwidth | float, *, streams: int = 2,
                 dtype_bytes: int = DTYPE_BYTES) -> float:
    """Memory-bound ceiling on point throughput, in Mpts/s."""
    return 1e6 / memory_s(1e6 * streams * dtype_bytes, bandwidth) / 1e6


def roofline_fraction(achieved_mpts: float, bandwidth: Bandwidth | float, *,
                      streams: int = 2,
                      dtype_bytes: int = DTYPE_BYTES) -> float:
    """Fraction of the memory-bound ceiling one measured row achieved."""
    return achieved_mpts / ceiling_mpts(bandwidth, streams=streams,
                                        dtype_bytes=dtype_bytes)


# ---------------------------------------------------------------------- gate
@dataclasses.dataclass(frozen=True)
class Breach:
    row: str
    kind: str                 # "regression" | "roofline" | "missing" | "failed"
    budget: float | None
    measured: float | None
    detail: str

    def render(self) -> str:
        return f"BREACH [{self.kind}] {self.row}: {self.detail}"


@dataclasses.dataclass
class GateReport:
    breaches: list[Breach]
    checked: list[str]
    skipped: list[str]            # baseline rows whose floor did not bind

    @property
    def ok(self) -> bool:
        return not self.breaches

    def render(self) -> str:
        lines = [f"perf gate: {len(self.checked)} rows checked, "
                 f"{len(self.breaches)} breach(es)"]
        for b in self.breaches:
            lines.append("  " + b.render())
        for s in self.skipped:
            lines.append(f"  note: {s}")
        if self.ok:
            lines.append("  PASS — every gated row within budget")
        return "\n".join(lines)

    def summary(self) -> dict:
        return {
            "ok": self.ok,
            "checked": self.checked,
            "skipped": self.skipped,
            "breaches": [dataclasses.asdict(b) for b in self.breaches],
        }


def check_gate(rows: list[dict], baseline: dict) -> GateReport:
    """Gate one benchmark run against the committed per-row budgets.

    ``rows``: the ``rows`` list of a BENCH_<rev>.json (the new schema:
    ``us_per_call``, optional ``mpts_per_s``/``fits_per_s``,
    ``roofline_frac``, ``interpret``, ``status``).
    ``baseline``: the parsed ``benchmarks/baseline.json``::

        {"default_max_slowdown": 3.0,
         "rows": {"<name>": {"ref_us": 123.4,
                             "max_slowdown": 2.5,        # optional
                             "min_roofline_frac": 0.05}, # optional
                  ...}}

    Per gated row: a ``failed`` status or a missing row is a breach (the
    trajectory must show holes, not pretend coverage); ``us_per_call``
    above ``ref_us × max_slowdown`` is a regression breach;
    ``roofline_frac`` below the floor is a breach **unless** the row ran
    in interpret mode (interpret rows are excluded from absolute floors —
    they prove correctness, not speed).
    """
    default_slow = float(baseline.get("default_max_slowdown", 3.0))
    by_name = {r.get("name"): r for r in rows}
    breaches: list[Breach] = []
    checked: list[str] = []
    skipped: list[str] = []

    for name, budget in baseline.get("rows", {}).items():
        checked.append(name)
        r = by_name.get(name)
        if r is None:
            breaches.append(Breach(name, "missing", None, None,
                                   "row absent from this run (bench did not "
                                   "produce it)"))
            continue
        if r.get("status", "ok") != "ok":
            breaches.append(Breach(
                name, "failed", None, None,
                f"row failed: {r.get('error', 'unknown error')}"))
            continue

        us = float(r["us_per_call"])
        ref = budget.get("ref_us")
        if ref is not None:
            cap = float(ref) * float(budget.get("max_slowdown",
                                                default_slow))
            if us > cap:
                breaches.append(Breach(
                    name, "regression", cap, us,
                    f"us_per_call={us:.1f} exceeds budget {cap:.1f} "
                    f"(ref {float(ref):.1f}us × "
                    f"{float(budget.get('max_slowdown', default_slow)):.2f} "
                    "max slowdown)"))

        floor = budget.get("min_roofline_frac")
        if floor is not None:
            frac = r.get("roofline_frac")
            if r.get("interpret"):
                skipped.append(f"{name}: interpret-mode row — roofline "
                               "floor not applied")
            elif frac is None:
                breaches.append(Breach(
                    name, "roofline", float(floor), None,
                    "baseline sets a roofline floor but the row carries "
                    "no roofline_frac"))
            elif float(frac) < float(floor):
                breaches.append(Breach(
                    name, "roofline", float(floor), float(frac),
                    f"roofline_frac={float(frac):.4f} below floor "
                    f"{float(floor):.4f} "
                    f"(achieved {r.get('mpts_per_s', '?')} Mpts/s vs the "
                    "memory-bound ceiling)"))
    return GateReport(breaches, checked, skipped)


def make_baseline(rows: list[dict], *, max_slowdown: float = 3.0,
                  roofline_margin: float = 0.5,
                  gated: tuple[str, ...] | None = None) -> dict:
    """Derive a fresh baseline from one run (``run.py --rebaseline``).

    ``ref_us`` is the run's min-of-reps timing; roofline floors are set at
    ``roofline_margin`` of the achieved fraction, only for rows that ran on
    hardware (never for interpret rows).
    """
    out: dict = {"default_max_slowdown": max_slowdown, "rows": {}}
    for r in rows:
        if r.get("status", "ok") != "ok":
            continue
        if gated is not None and r["name"] not in gated:
            continue
        budget: dict = {"ref_us": float(r["us_per_call"])}
        frac = r.get("roofline_frac")
        if frac is not None and not r.get("interpret"):
            budget["min_roofline_frac"] = round(float(frac)
                                                * roofline_margin, 5)
        out["rows"][r["name"]] = budget
    return out
