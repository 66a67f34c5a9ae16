"""moments_roofline.batch: percent of the card's HBM roofline that the
moments kernels reach in the profiled sub-window (``pbench/roofline.py``)."""
from pbench import readers

# the moments kernels (src/repro_torch/kernels/csrc/moments.cu) as the
# profiler names them
MOMENTS = ("moments_reg_kernel", "moments_smem_kernel", "moments_finalize")


def read(ctx):
    return readers.moments_roofline(ctx, MOMENTS)
