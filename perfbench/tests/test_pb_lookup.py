"""Every cell's configuration, traffic, limits, driver and per-layer
readers are found by name, and BENCHMARK.json keeps the contract's
shape."""
from __future__ import annotations

import re

import pytest

from pbench import cells

BENCH = cells.load_json(cells.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = cells.load_cell(cell, BENCH)
    assert callable(cells.system_driver(c).run)
    assert c.limits, "a cell's limits file names its compared numbers"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)


def test_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    every = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(every) == len(set(every))
    for n in every:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_files_and_reduced():
    for c in BENCH["configs"]:
        conf = cells.load_json(cells.ROOT / c["file"])
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert c["file"].startswith("perfbench/")


def test_four_card_cells_at_most_one():
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
