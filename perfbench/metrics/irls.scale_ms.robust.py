"""irls.scale_ms.robust: device ms per call of the robust scale's row
sorts and gathers in the profiled sub-window.  ``core/robust.py``
``chunk_scale`` (under its ``irls.scale`` span) finds each median by a
sort of every row (one of |y|, one of |r|; a scale a sweep and one at the
end) and a gather of the two middle values; nothing else on the IRLS
path sorts or gathers.  Left out: the sort's copies of its input and of
its int64 indices (``Memcpy DtoD`` and a generic copy kernel, ≈ 4% of a
call, whose names other copies share) and the scale's elementwise masks,
absolute values and count of live points, which run as kernels that
the rest of the sweep also runs."""
from pbench import readers

# as torch 2.11's profiler names them on an H100: the segmented sort of
# torch.sort along the last axis,
# at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<...Policy900, ...>
# (two instantiations), its index set-up
# at::native::(anonymous namespace)::fill_reverse_indices_kernel, and
# torch.take_along_dim's at::native::_scatter_gather_elementwise_kernel
SCALE = ("DeviceSegmentedRadixSortKernel", "fill_reverse_indices_kernel",
         "_scatter_gather_elementwise_kernel")


def read(ctx):
    return readers.device_ms_per(ctx, SCALE, "calls")
