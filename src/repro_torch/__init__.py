"""PyTorch/CUDA port of the matricized least-squares fitting package.

Mirrors ``src/repro`` path for path (``repro_torch/core/fit.py`` is the
counterpart of ``repro/core/fit.py``).  Plain tensor code is PyTorch; the
moment and report kernels are hand-written CUDA C++ for Hopper
(``repro_torch/kernels/csrc``).  Entry points take ``device=None``, which
means CUDA; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
