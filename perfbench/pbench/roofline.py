"""The yardstick's peaks and the byte counts of the moments kernels.

Peaks are the published figures of the card (NVIDIA's data sheet, H100
SXM5 80 GB, at its 700 W limit), never a measured triad: a share of a
published peak cannot pass 100% unless the bytes are counted too high or
the time leaves out part of the work.  A card not in the table gets no
roofline share (the readers return nothing).

The moments pass must read each input point's x and y once (float32,
8 bytes a point), whatever the program pads, weights or reads again:
the count is of what the inputs the benchmark handed in need.  Copied
from ``chip_smoke.py`` (``PEAK_BYTES_PER_S`` and its bytes-from-shapes
bound, commit 7ff5df5).
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}

MOMENT_BYTES_PER_POINT = 8     # x and y, float32, each read once


def peak(kind: str, what: str):
    return PEAKS.get(kind, {}).get(what)


def moment_bytes(points: int) -> int:
    return int(points) * MOMENT_BYTES_PER_POINT


def share_pct(bytes_: float, seconds: float, kind: str):
    """Percent of the card's HBM roofline: (bytes ÷ peak) ÷ seconds, or
    None where the card, the bytes or the time is unknown."""
    bw = peak(kind, "hbm_bytes_per_s")
    if bw is None or not bytes_ or not seconds or seconds <= 0:
        return None
    return 100.0 * bytes_ / bw / seconds
