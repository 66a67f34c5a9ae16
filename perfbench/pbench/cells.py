"""Find a cell and everything it names, by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
their configurations and metrics.  Each piece lives in a file of its own
under ``perfbench/``:

* a configuration: ``configs/<config>.json`` (the file ``BENCHMARK.json``
  names), whose ``system`` key names a driver ``systems/<system>.py``;
* a traffic mix: ``traffic/<traffic>.json``, read by ``pbench/gen.py``
  and by the driver (its ``arrivals``);
* the limits of the numbers that decide ``correct``: ``limits/<cell>.json``;
* a per-layer metric: a reader ``metrics/<metric>.py`` with ``read(ctx)``,
  which names the kernels it reads itself.

Adding a cell means adding files and a ``workloads`` entry, never editing
a file that exists.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]      # perfbench/
ROOT = BENCH.parent                                # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import one file by path under its own module name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents
    limits: dict            # number -> limit
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def system(self) -> str:
        return self.config["system"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name) and m["moves"] in names]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layer)


def system_driver(cell: Cell):
    return load_module(BENCH / "systems" / f"{cell.system}.py",
                       f"perfbench_system_{cell.system}")


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_"))
