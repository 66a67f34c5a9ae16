"""Known-bad corpus for RL-VMEM (port; opts into the kernels/tune.py scope
via its name): a ring block no configuration's shared memory holds, and
(csrc/ring.cu beside it) a cp.async copy committed but never waited."""

SMEM_BUDGET = 232_448
DEFAULT_BLOCK_N = 65536          # >= 540672 bytes even at bf16, one ring


def ring(x, moments_packed_ring):
    return moments_packed_ring(x, x, None, degree=3, block_n=131072, nbuf=2)
