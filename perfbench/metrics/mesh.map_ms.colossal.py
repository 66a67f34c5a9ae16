"""mesh.map_ms.colossal: device ms per call of rank 0's domain map in the
profiled sub-window: the global domain's min/max of the block
(``torch.aminmax``, one reduction) and the map of x into [-1, 1]
(``core/basis.py`` ``Domain.apply``: a subtraction, then a scaling in
place, each a pass over the block).  The solve's and the report's small
kernels, and every other reduction or elementwise kernel, are left out,
but for two few-µs multiplies a call by a scalar on the card, which run
as the map's scaling kernel does."""
from pbench import readers

# the map's kernels as torch 2.11's profiler names them on an H100 (each
# launched once for every 2^29 points of the block, past 32-bit indexing):
# at::native::reduce_kernel<512, 1, ReduceOp<float, MinMaxOps<...>>> for
# the min/max; at::native::elementwise_kernel<128, 2,
# gpu_kernel_impl_nocast<CUDAFunctor_add<float>>> for x - shift and
# <..., BinaryFunctor<..., MulFunctor<float>>> for the scaling (the
# non-vectorized kernels, since shift and scale broadcast from a 0-dim
# tensor on the card)
MAP = ("MinMaxOps<",
       "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<",
       "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, "
       "float, at::native::binary_internal::MulFunctor<")


def read(ctx):
    return readers.device_ms_per(ctx, MAP, "calls")
