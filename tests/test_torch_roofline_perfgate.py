"""The port's roofline and perf gate on the CPU: every test of
``tests/test_perfgate.py`` but the HLO-text parser's (which has no torch
counterpart), the roofline half of ``tests/test_sharding_roofline.py``,
``model_flops`` equal to the reference's for every arch and shape, and
``analyze`` reading FLOPs and collective bytes from one call."""
import math

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as rconfigs
from repro.configs.base import SHAPES as RSHAPES
from repro.launch import perfgate as rpg
from repro.launch import roofline as rroof
from repro_torch import configs as tconfigs
from repro_torch import engine
from repro_torch.configs.base import SHAPES
from repro_torch.launch import perfgate as pg
from repro_torch.launch import roofline as roof

settings.register_profile("torch_perfgate", deadline=None, max_examples=20)
settings.load_profile("torch_perfgate")


# ------------------------------------------------------------------ ceilings
def test_stream_bytes_counts_streams():
    assert pg.stream_bytes(1000) == 1000 * 2 * 4
    assert pg.stream_bytes(1000, streams=3) == 1000 * 3 * 4
    with pytest.raises(ValueError):
        pg.stream_bytes(-1)
    with pytest.raises(ValueError):
        pg.stream_bytes(10, streams=0)


@given(st.integers(0, 10**12), st.integers(1, 10**12))
def test_memory_s_monotone_in_bytes(extra, base):
    """More bytes can never take less time at fixed bandwidth."""
    bw = pg.Bandwidth(gbps=50.0, source="model", backend="cpu")
    assert pg.memory_s(base + extra, bw) >= pg.memory_s(base, bw)


def test_memory_s_validates_inputs():
    bw = pg.Bandwidth(gbps=10.0, source="model", backend="cpu")
    assert pg.memory_s(10e9, bw) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        pg.memory_s(-1.0, bw)
    with pytest.raises(ValueError):
        pg.memory_s(1.0, 0.0)


def test_ceiling_and_fraction_roundtrip():
    bw = pg.Bandwidth(gbps=80.0, source="measured", backend="cpu")
    # 2 f32 streams/point at 80 GB/s -> 10,000 Mpts/s ceiling
    assert pg.ceiling_mpts(bw) == pytest.approx(10_000.0)
    assert pg.roofline_fraction(1_000.0, bw) == pytest.approx(0.1)
    # 3 streams lowers the ceiling, raising the achieved fraction
    assert (pg.roofline_fraction(1_000.0, bw, streams=3)
            > pg.roofline_fraction(1_000.0, bw, streams=2))


@pytest.mark.parametrize("gbps", [0.5, 80.0, 3350.0])
@pytest.mark.parametrize("streams", [2, 3])
def test_ceilings_equal_the_reference(gbps, streams):
    """The pure-Python half is the reference's arithmetic: equal floats."""
    tbw = pg.Bandwidth(gbps=gbps, source="model", backend="cpu")
    rbw = rpg.Bandwidth(gbps=gbps, source="model", backend="cpu")
    assert pg.ceiling_mpts(tbw, streams=streams) == rpg.ceiling_mpts(
        rbw, streams=streams)
    assert pg.roofline_fraction(123.4, tbw, streams=streams) == \
        rpg.roofline_fraction(123.4, rbw, streams=streams)
    assert pg.memory_s(pg.stream_bytes(10**6, streams=streams), tbw) == \
        rpg.memory_s(rpg.stream_bytes(10**6, streams=streams), rbw)


def test_measure_bandwidth_sane_and_cached():
    bw = pg.measure_bandwidth(n_mb=4, reps=2, iters=2, device="cpu",
                              force=True)
    assert bw.backend == "cpu" and bw.source == "measured"
    assert 0.1 < bw.gbps < 1e5
    assert pg.measure_bandwidth(device="cpu") is bw          # cache hit
    assert pg.measure_bandwidth(device="cpu", force=True) is not bw


def test_measure_bandwidth_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pg.measure_bandwidth(n_mb=1)


def test_measure_bandwidth_raises_on_an_implausible_rate(monkeypatch):
    """A triad that reads out of range raises instead of reporting the
    hardware model's figure (the reference falls back to it)."""
    ticks = iter(range(0, 10**9, 10**6))       # 1e6 s per timed call
    monkeypatch.setattr(pg.time, "perf_counter", lambda: float(next(ticks)))
    with pytest.raises(RuntimeError, match="implausible"):
        pg.measure_bandwidth(n_mb=1, reps=1, iters=1, device="cpu",
                             force=True)


# ----------------------------------------------------------------------- gate
def _row(name, us, *, frac=None, interpret=False, status="ok", **kw):
    r = {"name": name, "us_per_call": us, "interpret": interpret,
         "status": status}
    if frac is not None:
        r["roofline_frac"] = frac
    r.update(kw)
    return r


BASELINE = {
    "default_max_slowdown": 3.0,
    "rows": {
        "moments_jnp": {"ref_us": 100.0},
        "serve_fit": {"ref_us": 200.0, "max_slowdown": 2.0},
        "moments_packed": {"ref_us": 50.0, "min_roofline_frac": 0.05},
    },
}


def test_gate_passes_within_budget():
    rows = [_row("moments_jnp", 250.0, frac=0.5),
            _row("serve_fit", 399.0),
            _row("moments_packed", 60.0, frac=0.10)]
    rep = pg.check_gate(rows, BASELINE)
    assert rep.ok and len(rep.checked) == 3
    assert "PASS" in rep.render()


def test_gate_regression_breach_names_row_and_budget():
    rows = [_row("moments_jnp", 100.0),
            _row("serve_fit", 401.0),                    # > 200 x 2.0
            _row("moments_packed", 50.0, frac=0.10)]
    rep = pg.check_gate(rows, BASELINE)
    assert not rep.ok
    (b,) = rep.breaches
    assert b.row == "serve_fit" and b.kind == "regression"
    assert b.budget == pytest.approx(400.0)
    assert b.measured == pytest.approx(401.0)
    assert "serve_fit" in rep.render() and "400.0" in b.detail


def test_gate_roofline_floor_binds_on_hardware_rows():
    rows = [_row("moments_jnp", 100.0),
            _row("serve_fit", 200.0),
            _row("moments_packed", 50.0, frac=0.01)]     # below 0.05 floor
    rep = pg.check_gate(rows, BASELINE)
    (b,) = rep.breaches
    assert b.row == "moments_packed" and b.kind == "roofline"
    assert b.budget == pytest.approx(0.05)


def test_gate_roofline_floor_excluded_for_interpret_rows():
    rows = [_row("moments_jnp", 100.0),
            _row("serve_fit", 200.0),
            _row("moments_packed", 50.0, frac=0.0001, interpret=True)]
    rep = pg.check_gate(rows, BASELINE)
    assert rep.ok
    assert any("interpret" in s for s in rep.skipped)


def test_gate_missing_and_failed_rows_breach():
    rows = [_row("moments_jnp", 100.0, status="failed", error="boom"),
            _row("moments_packed", 50.0, frac=0.10)]
    rep = pg.check_gate(rows, BASELINE)
    kinds = {b.row: b.kind for b in rep.breaches}
    assert kinds == {"moments_jnp": "failed", "serve_fit": "missing"}
    assert "boom" in next(b.detail for b in rep.breaches
                          if b.kind == "failed")


def test_make_baseline_sets_floors_only_on_hardware_rows():
    rows = [_row("a", 100.0, frac=0.2, interpret=False),
            _row("b", 50.0, frac=0.3, interpret=True),
            _row("c", 10.0, status="failed"),
            _row("d", 10.0)]
    base = pg.make_baseline(rows, roofline_margin=0.5, gated=("a", "b", "c"))
    assert base["rows"]["a"] == {"ref_us": 100.0, "min_roofline_frac": 0.1}
    assert base["rows"]["b"] == {"ref_us": 50.0}         # interpret: no floor
    assert "c" not in base["rows"]                       # failed: no budget
    assert "d" not in base["rows"]                       # not gated
    # and the derived baseline gates its own run clean
    assert pg.check_gate(rows, base).ok


@pytest.mark.parametrize("rows", [
    [_row("moments_jnp", 250.0, frac=0.5), _row("serve_fit", 399.0),
     _row("moments_packed", 60.0, frac=0.10)],
    [_row("moments_jnp", 100.0, status="failed", error="boom"),
     _row("moments_packed", 50.0, frac=0.01)],
    [_row("moments_jnp", 301.0), _row("serve_fit", 200.0),
     _row("moments_packed", 50.0)],
])
def test_gate_report_equals_the_reference(rows):
    assert pg.check_gate(rows, BASELINE).summary() == \
        rpg.check_gate(rows, BASELINE).summary()
    assert pg.make_baseline(rows) == rpg.make_baseline(rows)


# -------------------------------------------------------------- roofline
def test_roofline_terms():
    r = roof.Roofline(flops=989e12, bytes_accessed=3.35e12,
                      coll_bytes=450e9, coll_breakdown={},
                      peak_memory=8 << 30)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 1.0) < 1e-9
    assert r.step_s == max(r.compute_s, r.memory_s, r.collective_s)
    half = roof.Roofline(flops=989e12 / 2, bytes_accessed=3.35e12,
                         coll_bytes=0.0, coll_breakdown={}, peak_memory=0)
    assert half.dominant == "memory"
    assert half.summary()["step_s"] == pytest.approx(1.0)
    assert half.summary()["peak_memory_gb"] == 0.0


def test_model_flops():
    cfg = tconfigs.get_config("yi-6b")
    mf = roof.model_flops(cfg, SHAPES["train_4k"], 1_048_576)
    # yi-6b ≈ 6.06B params → 6·N·D ≈ 3.8e16
    assert 2e16 < mf < 6e16
    cfg_moe = tconfigs.get_config("dbrx-132b")
    act = cfg_moe.active_param_count()
    tot = cfg_moe.param_count()
    assert 0.2 < act / tot < 0.35   # 16 experts top-4 + attn + embed


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
@pytest.mark.parametrize("shape", list(RSHAPES))
def test_model_flops_equal_the_reference(arch, shape):
    n = RSHAPES[shape].global_batch * RSHAPES[shape].seq_len
    assert roof.model_flops(tconfigs.get_config(arch), SHAPES[shape], n) \
        == rroof.model_flops(rconfigs.get_config(arch), RSHAPES[shape], n)


def test_analyze_counts_flops_and_collective_bytes():
    """A (64, 32) @ (32, 16) product is 2·64·32·16 FLOPs; a recorded
    all-reduce of 400 payload bytes is 800 wire bytes; peak memory is 0
    on the CPU; the caller's bytes pass through."""
    a, b = torch.ones(64, 32), torch.ones(32, 16)

    def fn(x, y, *, tag):
        engine.record_collective("sum", 400)
        return (x @ y).sum() if tag else None

    r = roof.analyze(fn, a, b, tag=True, bytes_accessed=4 * (64 * 32
                                                             + 32 * 16),
                     device="cpu")
    assert r.flops == 2 * 64 * 32 * 16
    assert r.coll_bytes == 800.0 and r.coll_breakdown == {"all-reduce": 800.0}
    assert r.peak_memory == 0
    assert r.memory_s == pytest.approx(4 * (64 * 32 + 32 * 16) / 3.35e12)
    quiet = roof.analyze(lambda: a @ b, device="cpu")
    assert quiet.coll_bytes == 0.0 and quiet.coll_breakdown == {}
    assert math.isclose(quiet.compute_s, 2 * 64 * 32 * 16 / 989e12)
