"""One run of one cell: set the caches, hand the cell to its system's
driver, read the per-layer metrics, decide ``correct`` and build the
result line.

``run.py`` is the command; this module is also what the CPU tests drive
(``device="cpu"``, small overrides), so it never looks for a card itself.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Any

from pbench import cells as cells_lib
from pbench import devtrace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_dirs(root) -> None:
    """Every build and kernel cache the program could use, at fixed paths
    inside the checkout (only the first run of a cell there builds).  The
    port's own kernel build lands in ``src/repro_torch/kernels/_build``,
    also inside the checkout."""
    base = os.path.join(str(root), ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "nv")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is ``jax``, ``jaxlib``,
    ``flax`` or the JAX package ``repro``, compared whole (``repro_torch``
    is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def log(*a) -> None:
    print("[perfbench]", *a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Ctx:
    """What a system driver gets: the cell, the run's arguments, the
    device, the span recorder, and the configuration ``cf`` and traffic
    ``tr`` as the cell's files give them, with ``overrides`` on top (the
    CPU tests shrink sizes; the command passes none)."""

    torch: Any
    device: Any
    cell: cells_lib.Cell
    seed: int
    seconds: float
    trace: bool
    spans: devtrace.Spans
    overrides: dict

    def __post_init__(self):
        self.cf = {**self.cell.config, **self.overrides.get("config", {})}
        self.tr = {**self.cell.traffic, **self.overrides.get("traffic", {})}

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(self.torch.cuda.max_memory_allocated(self.device))
        return 0

    def profile(self) -> devtrace.Profile:
        return devtrace.Profile(self.torch, self.device, self.spans)


def disk_written_bytes() -> int | None:
    """Bytes this process has caused to be written (``/proc/self/io``)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def _finite(v):
    return v is not None and isinstance(v, (int, float)) and math.isfinite(v)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             *, t_start: float, overrides: dict | None = None) -> dict:
    """Run the cell once and return the result line as a dict, with the
    compared numbers under ``checks`` (last)."""
    import torch
    cell = cells_lib.load_cell(name)
    ctx = Ctx(torch=torch, device=torch.device(device), cell=cell,
              seed=int(seed), seconds=float(seconds), trace=bool(trace),
              spans=devtrace.Spans(), overrides=dict(overrides or {}))
    out = cells_lib.system_driver(cell).run(ctx)
    setup_s = out["window_start"] - t_start
    for k, v in sorted(out.get("info", {}).items()):
        log(f"{k} = {v}")
    log(f"setup_s = {setup_s!r}")
    dev_info = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(ctx.device)
                         if ctx.device.type == "cuda" else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    if not trace:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if _finite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        lctx = dict(out["layer"], device_kind=dev_info["kind"])
        for m in cell.per_layer:
            v = cells_lib.metric_reader(m["name"]).read(lctx)
            if _finite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_info["busy_s"] = out["layer"]["busy_s"]
        dev_info["window_s"] = out["layer"]["window_s"]
    checks = {}
    correct = True
    for cname, value in out["checks"].items():
        limit = cell.limits[cname]
        ok = _finite(value) and value <= limit
        correct = correct and ok
        checks[cname] = {"value": value if _finite(value) else str(value),
                         "limit": limit}
    failed = int(out["failed"])
    correct = correct and failed == 0
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace and out.get("breakdown") is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for cname, c in result["checks"].items():
        print(f"[perfbench] check {cname} = {c['value']!r} "
              f"(limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)

