"""Known-good corpus for RL-VMEM (port): a feasible ring block, and
(csrc/ring.cu beside it) cp.async copies committed and waited."""

SMEM_BUDGET = 232_448
DEFAULT_BLOCK_N = 1024


def ring(x, moments_packed_ring):
    return moments_packed_ring(x, x, None, degree=3, block_n=512, nbuf=2)
