"""Hand-written Hopper kernels of the port and their wrappers.

The paper's own contribution was a CUDA moment kernel; the JAX reference
re-expressed it as Pallas TPU kernels, and this package takes it back to
the GPU: ``csrc/moments.cu`` and ``csrc/moments_ring.cu`` (built by
``build.py``), launched by ``moments.py``, wrapped by ``ops.py``, with the
ring's block size tuned by ``tune.py`` and the plain PyTorch oracles in
``ref.py``.  ``csrc/solve.cu``, launched by ``solve.py``, does the batched
small solve of ``core.solve.solve_with_fallback`` on the card."""
from repro_torch.kernels.ops import moments as compute_moments  # noqa: F401
# (exported under a distinct name so the ``kernels.moments`` submodule
# stays importable)

__all__ = ["compute_moments"]
