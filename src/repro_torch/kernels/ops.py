"""Public wrappers around the moment/report kernels (port of
``repro.kernels.ops``).

Handles batch shapes (any leading axes), packed-vs-plain path selection,
the ring form of the packed kernel (``nbuf >= 2``), the true-count
versus Σw split, and extraction of ``Moments`` from the kernels' extended
Gram.  The kernels bound-check ragged tails themselves and treat a missing
weight array as all ones, so no padding copy is made: the results equal
the reference's zero-weight padding.

Count semantics: ``Moments.count`` is the TRUE number of contributing
points (nonzero weight) and ``Moments.weight_sum`` is Σw, as on the
reference path.
"""
from __future__ import annotations

import torch

from repro_torch.core.moments import Moments
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels import moments as kernel


def _true_count(weights, b, n, dtype, device):
    if weights is None:
        return torch.full((b,), n, dtype=dtype, device=device)
    return torch.sum((weights != 0).to(dtype), dim=-1)


def _read_as_is(x, y) -> bool:
    """x and y are of one dtype the kernels read."""
    return x.dtype == y.dtype and x.dtype in (torch.float32, torch.bfloat16,
                                              torch.float64)


def _kernel_inputs(x, y, weights, accum_dtype):
    """x/y in one dtype the kernels read (else both in accum_dtype),
    weights in accum_dtype; all contiguous."""
    if not _read_as_is(x, y):
        x, y = x.to(accum_dtype), y.to(accum_dtype)
    w = None if weights is None else weights.to(accum_dtype).contiguous()
    return x.contiguous(), y.contiguous(), w


def _ring_block(degree, n, itemsize, weighted, nbuf, accum_itemsize, dev):
    """``block_n`` for a ring call that gives none: the smallest candidate
    that covers the series in one block (the reference's rule), else the
    largest that fits the ring's shared memory."""
    from repro_torch.kernels import tune
    fit = tune.feasible_blocks(degree, nbuf=nbuf, itemsize=itemsize,
                               weighted=weighted,
                               accum_itemsize=accum_itemsize,
                               budget=tune.smem_budget(dev))
    if not fit:
        raise ValueError(f"no ring block fits the shared memory at degree "
                         f"{degree}, nbuf={nbuf}")
    return next((bn for bn in fit if bn >= n), fit[-1])


def moments(x, y, degree: int, *, weights=None, block_n: int | None = None,
            accum_dtype=torch.float32, packing: str = "auto",
            compensated: bool = False, nbuf: int = 0,
            domain=None, device=None) -> Moments:
    """Kernel-backed equivalent of ``core.gram_moments``.

    Accepts (..., n) inputs of float32, bfloat16 or float64 (the leading
    axes are flattened into one series batch for the kernel and restored
    on every field); returns Moments accumulated in ``accum_dtype``
    (float32 by default) with the input's batch shape.  ``packing`` ∈
    {"auto", "packed", "plain"} picks the kernel; ``compensated=True``
    turns on Kahan accumulation.  ``nbuf >= 2`` streams the packed
    kernel's loads through an ``nbuf``-slot shared-memory ring in blocks
    of ``block_n`` points (pick it with ``tune.autotune_block_n``); the
    result has the same bits as ``nbuf=0``.  With ``nbuf=0`` ``block_n``
    is accepted and changes nothing: the grid-streamed kernels read each
    point straight from device memory.  ``domain`` (a ``core.Domain``):
    the moments of ``domain.apply(x)``, bit for bit; the kernel maps each x
    value as it loads it, unless x would reach it converted or the
    domain's scalars are not 0-d in x's dtype on x's device, where x is
    mapped first.  ``device=None`` means CUDA."""
    if packing not in ("auto", "packed", "plain"):
        raise ValueError(f"packing={packing!r}; expected 'auto', 'packed' "
                         "or 'plain'")
    if nbuf == 1 or nbuf < 0:
        raise ValueError(f"nbuf={nbuf}: 0 (grid-streamed) or >= 2 "
                         "(multi-buffered ring)")
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    if accum_dtype is None:
        accum_dtype = torch.float32
    if x.ndim == 0 or y.shape != x.shape:
        raise ValueError(f"moments expects x, y of one (..., n) shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    batch = tuple(x.shape[:-1])
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    yb = y.reshape(-1, n)
    b = xb.shape[0]
    weights = (None if weights is None
               else torch.broadcast_to(as_tensor(weights, dev), x.shape)
               .reshape(b, n))
    count = _true_count(weights, b, n, accum_dtype, dev)
    weight_sum = (torch.full((b,), n, dtype=accum_dtype, device=dev)
                  if weights is None
                  else torch.sum(weights, dim=-1).to(accum_dtype))

    pfac = kernel.packing_factor(degree)
    use_packed = (packing == "packed"
                  or (packing == "auto" and b > 1 and pfac > 1))
    if use_packed and pfac < 2:
        raise ValueError(f"degree {degree} leaves no room to pack "
                         f"(packing_factor={pfac}); use packing='plain'")
    if nbuf >= 2 and not use_packed:
        raise ValueError("nbuf (the multi-buffered ring) is a packed-"
                         "kernel knob; this call resolved to the plain "
                         "layout")
    shift = scale = None
    if domain is not None:
        # the kernel maps x where it reads x as it is and takes the map
        if _read_as_is(xb, yb) and kernel.map_error(
                xb, domain.shift, domain.scale) is None:
            shift, scale = domain.shift, domain.scale
        else:
            xb = domain.apply(xb)
    xk, yk, wk = _kernel_inputs(xb, yb, weights, accum_dtype)
    common = dict(degree=degree, accum_dtype=accum_dtype,
                  compensated=compensated, shift=shift, scale=scale)
    if nbuf >= 2:
        if block_n is None:
            block_n = _ring_block(degree, n, xk.element_size(),
                                  wk is not None, nbuf,
                                  torch.empty((), dtype=accum_dtype)
                                  .element_size(), dev)
        g = kernel.moments_packed_ring(xk, yk, wk, block_n=block_n,
                                       nbuf=nbuf, **common)
    elif use_packed:
        g = kernel.moments_packed(xk, yk, wk, **common)
    else:
        g = kernel.moments_plain(xk, yk, wk, **common)
    m1 = degree + 1
    return Moments(gram=g[:, :m1, :m1].reshape(batch + (m1, m1)),
                   vty=g[:, :m1, m1].reshape(batch + (m1,)),
                   yty=g[:, m1, m1].reshape(batch),
                   count=count.reshape(batch),
                   weight_sum=weight_sum.reshape(batch))


def fused_report_sums(x, y, coeffs, *, weights=None,
                      accum_dtype=torch.float32,
                      device=None) -> dict[str, torch.Tensor]:
    """One-pass evaluation/residual sums for ``core.fit_report_streamed``.

    x, y: (..., n); coeffs: (..., m+1) monomial coefficients in the same
    (already domain-mapped) x.  Returns (...,)-shaped ``sw, sy, syy, sf,
    sff, syf, sse`` — Σw, Σwy, Σwy², Σwf, Σwf², Σwyf, Σw(y-f)²."""
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    coeffs = as_tensor(coeffs, dev)
    if accum_dtype is None:
        accum_dtype = torch.float32
    degree = coeffs.shape[-1] - 1
    if degree + 1 > kernel.K_PAD:
        raise ValueError(f"degree {degree} too large for K_PAD={kernel.K_PAD}")
    batch = tuple(x.shape[:-1])
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    yb = y.reshape(-1, n)
    b = xb.shape[0]
    wb = (None if weights is None
          else torch.broadcast_to(as_tensor(weights, dev), x.shape)
          .reshape(-1, n))
    cb = torch.broadcast_to(coeffs, batch + coeffs.shape[-1:]).reshape(b, -1)
    xk, yk, wk = _kernel_inputs(xb, yb, wb, accum_dtype)
    sums = kernel.fused_report(xk, yk, wk, cb.to(accum_dtype).contiguous(),
                               accum_dtype=accum_dtype)
    return {name: sums[:, j].reshape(batch)
            for j, name in enumerate(kernel.REPORT_NAMES)}
