"""Launcher of the batched small-solve kernel (``csrc/solve.cu``).

``solve_small`` does ``core.solve.solve_with_fallback`` at
``method="gauss"`` for a batch of (k, k) systems in one launch, with no
read back to the host: the condition estimate, Gauss-Jordan with partial
pivoting (the bits of ``core.solve.gaussian_elimination``) and, only for
the series whose guard trips, the SVD rescue.  ``solve_with_fallback``
hands it every call that ``takes`` accepts; its plain version is
``core.solve.solve_with_fallback_plain``, which every other call, and every
CPU call, runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import moments as _registry

MAX_K = 8                     # csrc/solve.cu kMaxK: one instantiation a k
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_FALLBACK_CODES = {None: 0, "svd": 1, "gauss": 2}


def _refusal(a, b, method, fallback):
    """Why the kernel cannot take ``solve_with_fallback(a, b, method=,
    fallback=)``, as (exception type, message); None where it can.  Reads
    only the inputs' device, dtype and shape."""
    if method != "gauss" or fallback not in _FALLBACK_CODES:
        return ValueError, (f"solve_small runs method='gauss' with fallback "
                            f"in {list(_FALLBACK_CODES)}, got "
                            f"method={method!r}, fallback={fallback!r}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        return TypeError, (f"a/b dtypes {a.dtype}/{b.dtype}: one of "
                           f"{list(_DTYPE_CODES)} expected for both")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2] or b.shape != a.shape[:-1]:
        return ValueError, (f"expected a (..., k, k) and b (..., k), got "
                            f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not 1 <= a.shape[-1] <= MAX_K:
        return ValueError, (f"k={a.shape[-1]}: the kernel solves 1 <= k <= "
                            f"{MAX_K}")
    if a.device.type != "cuda" or b.device != a.device:
        return ValueError, "a and b must lie on one CUDA device"
    return None


def takes(a, b, method: str, fallback: str | None) -> bool:
    """Whether the kernel takes a ``solve_with_fallback`` call: a and b on
    one CUDA device, float32 or float64 alike, a (..., k, k) with b
    (..., k), k <= 8, the ``gauss`` rung with an SVD, Gauss or no
    fallback."""
    return _refusal(a, b, method, fallback) is None


def solve_small(a: torch.Tensor, b: torch.Tensor, *, method: str = "gauss",
                fallback: str | None = "svd", cond_cap: float):
    """``(x, cond, fallback_used)`` of ``solve_with_fallback`` for a
    (..., k, k) Gram and its (..., k) right-hand side on the card, in one
    launch on the current stream.  Strided inputs are read in place (a
    Gram sliced out of the moment kernel's extended buffer is)."""
    refusal = _refusal(a, b, method, fallback)
    if refusal is not None:
        raise refusal[0](refusal[1])
    from repro_torch.kernels import build
    k = a.shape[-1]
    # a (B, k, k) batch, the fit's case, is passed as it lies: a reshape
    # costs the host two more dispatches a call
    a3, b2 = ((a, b) if a.ndim == 3
              else (a.reshape(-1, k, k), b.reshape(-1, k)))
    x = torch.empty(a.shape[:-1], dtype=a.dtype, device=a.device)
    cond = torch.empty(a.shape[:-2], dtype=a.dtype, device=a.device)
    used = torch.empty(a.shape[:-2], dtype=torch.bool, device=a.device)
    if a3.shape[0] == 0:
        return x, cond, used
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = build.library().repro_solve_small(
            _DTYPE_CODES[a.dtype], k, _FALLBACK_CODES[fallback],
            a3.data_ptr(), *a3.stride(), b2.data_ptr(), *b2.stride(),
            a3.shape[0], float(cond_cap), x.data_ptr(), cond.data_ptr(),
            used.data_ptr(), stream)
    _registry._raise_on(err, "solve_small")
    _registry._count_launch("solve_small")
    return x, cond, used
