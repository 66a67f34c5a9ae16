"""The frozen byte count and the readers that turn a trace into the
per-layer metrics."""
from __future__ import annotations

import pytest

from pbench import cells, devtrace, readers, roofline

H100 = "NVIDIA H100 80GB HBM3"
MOMENTS = ("moments_reg_kernel", "moments_finalize")


def test_moment_bytes_from_shapes():
    # a (4096, 65536) float32 batch: x and y read once
    assert roofline.moment_bytes(4096 * 65536) == 2 * 4 * 4096 * 65536


def test_roofline_share_from_synthetic_trace():
    pts = 4096 * 65536
    t_us = 800.0
    ev = [("void moments_reg_kernel<float, float>(float const*)", "kernel",
           10.0, t_us),
          ("void moments_finalize<float>(float const*)", "kernel", 820.0,
           0.0),
          ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 900.0, 5.0)]
    ctx = {"events": ev, "counts": {"points": pts, "calls": 1},
           "device_kind": H100}
    share = readers.moments_roofline(ctx, MOMENTS)
    assert share == pytest.approx(100 * 8 * pts / 3.35e12 / (t_us / 1e6))
    assert readers.device_ms_per(ctx, MOMENTS, "calls") == \
        pytest.approx(0.8)
    assert cells.metric_reader("moments_roofline.batch").read(ctx) == share
    ctx["device_kind"] = "some other card"
    assert readers.moments_roofline(ctx, MOMENTS) is None
    assert readers.moments_roofline({"events": [], "counts": {}},
                                    MOMENTS) is None


def test_busy_union_and_gaps():
    ev = [("k1", "kernel", 0.0, 10.0), ("k2", "kernel", 5.0, 10.0),
          ("c", "gpu_memcpy", 40.0, 10.0)]
    spans = [("pb.step", "user_annotation", 14.0, 30.0)]
    assert devtrace.busy_s(ev, 0.0, 100.0) == pytest.approx(25e-6)
    b = devtrace.breakdown(ev, spans, 0.0, 100.0)
    assert b["idle_gaps"][0] == ["host.outside_spans", pytest.approx(50e-6)]
    assert b["idle_gaps"][1] == ["pb.step", pytest.approx(25e-6)]
    assert devtrace.short_name("void moments_reg_kernel<a, b>(int)") == \
        "moments_reg_kernel"

