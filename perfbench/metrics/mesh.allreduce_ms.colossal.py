"""mesh.allreduce_ms.colossal: device ms per call of the NCCL all-reduce
kernels on rank 0 in the profiled sub-window: the global domain's MIN and
MAX and the moments' SUM (``core/distributed.py`` ``_all_reduce``), the
wait for slower ranks included.  The cell's per-call broadcasts
(``systems/mesh_fit.py``) are not all-reduces."""
from pbench import readers

# NCCL's all-reduce kernels as the profiler names them: with torch
# 2.11's NCCL on four H100s the three of a call all run as
# ncclDevKernel_AllReduce_Sum_f32_RING_LL; the broadcasts as
# ncclDevKernel_Broadcast_RING_LL
ALLREDUCE = ("AllReduce",)


def read(ctx):
    return readers.device_ms_per(ctx, ALLREDUCE, "calls")
