"""Every cell's configuration, traffic, limits, driver and per-layer
readers are found by name, and BENCHMARK.json keeps the contract's
shape."""
from __future__ import annotations

import re

import pytest

import pb_small
from pbench import cells

BENCH = cells.load_json(cells.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
SYSTEMS = sorted({cells.load_cell(c, BENCH).system for c in CELLS})


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = cells.load_cell(cell, BENCH)
    driver = cells.system_driver(c)
    assert callable(driver.run)
    if c.chips > 1:
        assert callable(driver.peer), "a driver on cards > 1 has peer(ctx)"
    assert c.limits, "a cell's limits file names its compared numbers"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)


@pytest.mark.parametrize("system", SYSTEMS)
def test_system_has_small_settings(system):
    path = pb_small.small_file(system)
    assert path.is_file(), (
        f"{path.relative_to(cells.ROOT)} is missing: the CPU tests run "
        f"{system}'s cells at the sizes, for the seconds and with the "
        f"faults it names (SECONDS, overrides(cell), FAULTS)")
    small = pb_small.system_settings(system)
    assert small.SECONDS > 0 and callable(small.overrides)
    assert small.FAULTS and all(callable(f) for f in small.FAULTS.values())


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
