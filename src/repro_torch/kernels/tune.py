"""``block_n`` for the ring form of the packed moment kernel (port of
``repro.kernels.tune``).

The ring kernel's free parameter is ``block_n``, the points each slot of
the ``nbuf``-slot shared-memory ring holds.  Small blocks issue more
copy groups per point; large blocks take more shared memory, which
leaves fewer CTAs resident on an SM (a 128 KiB ring leaves one).  Which
side wins depends on the degree, the dtype, ``nbuf``, whether weights are
streamed, and the card, so ``autotune_block_n`` runs a ONE-SHOT sweep over
the candidates that fit a block's shared memory, timed with CUDA events,
and caches the winner per (degree, dtype, device name, nbuf, weighted)
for the life of the process.  The key holds ``nbuf`` and ``weighted``
because on Hopper they decide which blocks can launch at all.

Candidates that do not fit are removed by the budget model before any
launch; a candidate that fails to launch raises.  ``clear_cache()``
resets the cache (tests).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import moments as kernel

# candidate ring blocks (points per slot), multiples of 32
CANDIDATE_BLOCKS = (128, 256, 512, 1024, 2048)
# shared memory one block may opt in to on sm_90: the budget for planning
# off the card; on a card the sweep reads the card's own (smem_budget)
SMEM_BUDGET = 232_448

_CACHE: dict[tuple, int] = {}
_TIMES: dict[tuple, dict[int, float]] = {}


def _slot_bytes(block_n: int, itemsize: int) -> int:
    """One array's slot: the aligned words that cover ``block_n`` points,
    one word of head room, 16-byte rounded.  The layout is decided by
    ``Slot<T>::bytes`` in ``csrc/moments_ring.cu``; this copy plans off the
    card, and ``tests/test_torch_cuda.py`` holds ``ring_smem_bytes`` to the
    library's ``repro_ring_smem_bytes``."""
    word = max(itemsize, 4)
    return -(-(block_n * itemsize + word) // 16) * 16


def ring_smem_bytes(degree: int, block_n: int, *, nbuf: int = 2,
                    itemsize: int = 4, weighted: bool = False,
                    compensated: bool = False,
                    accum_itemsize: int = 4) -> int:
    """Shared memory one CTA of the ring kernel takes: the rings of its
    tasks (eight at degree <= 14, one above) plus, above degree 14, the
    static tile of the shared-memory path.  ``itemsize`` is x's and y's,
    ``accum_itemsize`` the weights' (they are streamed in the
    accumulation dtype).  Kahan's (hi, lo) pairs live in registers and
    the split partials, so ``compensated`` changes nothing here; it stays
    in the signature only to match the reference's ``ring_vmem_bytes``."""
    reg = degree <= kernel.REGISTER_MAX_DEGREE
    tasks = kernel.SERIES_PER_PACKED_CTA if reg else 1
    per_set = 2 * _slot_bytes(block_n, itemsize) + (
        _slot_bytes(block_n, accum_itemsize) if weighted else 0)
    tile = 0 if reg else (kernel.TILE_POINTS * (kernel.MAX_POWERS + 1)
                          + kernel.TILE_POINTS) * accum_itemsize
    return tasks * nbuf * per_set + tile


def feasible_blocks(degree: int, *, nbuf: int = 2, itemsize: int = 4,
                    weighted: bool = False, accum_itemsize: int = 4,
                    budget: int = SMEM_BUDGET) -> tuple[int, ...]:
    """The candidates whose ring fits ``budget`` (may be empty)."""
    return tuple(b for b in CANDIDATE_BLOCKS
                 if ring_smem_bytes(degree, b, nbuf=nbuf, itemsize=itemsize,
                                    weighted=weighted,
                                    accum_itemsize=accum_itemsize) <= budget)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def smem_budget(device=None) -> int:
    """Shared memory one block may opt in to: the card's own figure on a
    CUDA device, ``SMEM_BUDGET`` elsewhere."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return SMEM_BUDGET
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def _elapsed_ms(fn, dev: torch.device, reps: int, timer) -> float:
    """Best of ``reps`` runs of ``fn`` after a warm-up: CUDA events, or
    ``timer`` (seconds, host clock) around a synchronized run."""
    fn()
    if timer is None:
        best = float("inf")
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        return best
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = timer()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, (timer() - t0) * 1e3)
    return best


def autotune_block_n(degree: int, n: int | None = None, *,
                     dtype=torch.float32, nbuf: int = 2,
                     weighted: bool = False, device=None, reps: int = 2,
                     timer=None, force: bool = False) -> int:
    """Pick ``block_n`` for ``ops.moments(..., nbuf=nbuf)`` from a
    one-shot timed sweep over ``feasible_blocks``.

    The sweep runs the ring kernel on one group of P = packing_factor
    series per SM (so the grid fills the card as a batched call does) of
    ``n`` points (default: twice the largest candidate).  The winner is
    cached per (degree, dtype, device name, nbuf, weighted), not per n.
    ``device=None`` means CUDA; the sweep is timed with CUDA events unless
    ``timer`` (a host clock in seconds) is given, which a CPU sweep needs.
    Raises when no candidate fits."""
    dev = resolve_device(device)
    dtype = torch.empty((), dtype=dtype).dtype
    key = (degree, str(dtype).removeprefix("torch."), _device_name(dev),
           nbuf, weighted)
    if not force and key in _CACHE:
        return _CACHE[key]
    if timer is None and dev.type != "cuda":
        raise ValueError("the sweep is timed with CUDA events; pass timer= "
                         "to sweep on the CPU")
    budget = smem_budget(dev)
    cands = feasible_blocks(degree, nbuf=nbuf, itemsize=dtype.itemsize,
                            weighted=weighted, budget=budget)
    if not cands:
        raise ValueError(f"no ring block fits {budget} bytes of shared "
                         f"memory at degree {degree}, nbuf={nbuf}")
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    b = max(2, kernel.packing_factor(degree)) * sms
    n_sweep = 2 * max(cands) if n is None else int(n)
    x = torch.linspace(-1.0, 1.0, n_sweep, device=dev).to(dtype)
    x = x.expand(b, n_sweep).contiguous()
    w = torch.ones(x.shape, device=dev) if weighted else None
    times = {}
    for bn in cands:
        times[bn] = _elapsed_ms(
            lambda: kernel.moments_packed_ring(x, x, w, degree=degree,
                                               block_n=bn, nbuf=nbuf),
            dev, reps, timer)
    best = min(cands, key=lambda bn: times[bn])
    _CACHE[key] = best
    _TIMES[key] = times
    return best


def sweep_times() -> dict[tuple, dict[int, float]]:
    """Each cached sweep's time per candidate block (ms), by cache key."""
    return {k: dict(v) for k, v in _TIMES.items()}


def clear_cache() -> None:
    _CACHE.clear()
    _TIMES.clear()
