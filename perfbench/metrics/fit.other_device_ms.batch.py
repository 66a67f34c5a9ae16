"""fit.other_device_ms.batch: device ms per call (``api.fit``, or a
stream's updates and ``stream_result``) spent outside the moments kernels
(the domain map, the solve, the report, copies) in the profiled
sub-window."""
from pbench import devtrace

# the moments kernels (src/repro_torch/kernels/csrc/moments.cu) as the
# profiler names them
MOMENTS = ("moments_reg_kernel", "moments_smem_kernel", "moments_finalize")


def read(ctx):
    ev = ctx.get("events") or []
    calls = (ctx.get("counts") or {}).get("calls")
    if not ev or not calls:
        return None
    other = devtrace.total_s(ev) - devtrace.total_s(
        devtrace.matching(ev, MOMENTS))
    return other * 1e3 / calls
