"""Launchers of the Hopper moment and report kernels, with their plain
PyTorch versions beside them.

Each launcher takes (B, n) inputs and, for a CUDA tensor, checks shapes,
dtypes, contiguity and device, allocates its outputs and split partials,
launches its kernel (``csrc/*.cu``) on the current stream, raises if
the launch failed, and adds one to its launch count.  For a CPU tensor it
returns its plain version instead; the plain versions are also the oracles
the card is checked against.

=======================  ====================================================
launcher                 replaces (``repro/kernels/moments.py``)
=======================  ====================================================
``moments_plain``        ``_moments_kernel`` via ``moments_extended``
                         (:133, :296)
``moments_packed``       ``_packed_moments_kernel`` via
                         ``moments_packed_extended`` with ``nbuf=0``
                         (:185, :327)
``moments_packed_ring``  ``_packed_moments_db_kernel`` via
                         ``moments_packed_extended`` with ``nbuf>=2``
                         (:197, :356)
``fused_report``         ``_fused_report_kernel`` via ``fused_report_sums``
                         (:251, :392)
=======================  ====================================================

``moments_packed_ring`` is ``moments_packed``'s own kernel
(``csrc/moments_common.cuh``) instantiated with its loads streamed through
an ``nbuf``-slot ring in shared memory by ``cp.async``
(``csrc/moments_ring.cu``), so its output has the same bits; it is bound
by the same bytes, and the ring's shared memory trades resident warps for
deeper prefetch (``tune.py`` measures that trade).  Its plain version is
``moments_block_plain``: the ring changes no arithmetic.

The moment kernels map each x value as they load it, ``(x - shift) *
scale`` rounded as ``core.basis.Domain.apply`` rounds it: the launchers'
``shift`` and ``scale`` (0-d tensors of x's dtype on x's device), else
the identity's 0 and 1, under which x keeps its bits.  So the result has
the bits of the same launch on ``Domain.apply(x)`` and no mapped copy of
x is written.  The plain versions map first, with ``Domain.apply``.

The moment launchers return each series' K×K extended Gram (K = degree+2,
rows and columns x⁰…xᵐ, y), not the TPU kernels' 128×128 tile: the padding
and the packed tile's cross-series blocks are MXU artefacts.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.obs import spans

K_PAD = 128                   # the reference tile: degree + 2 <= 128
# these two mirror csrc/moments_common.cuh (kRegMaxDegree, kThreads)
REGISTER_MAX_DEGREE = 14      # above this the kernels use shared memory
THREADS = 256                 # threads per CTA
SERIES_PER_PACKED_CTA = THREADS // 32   # moments_packed: one warp per task
CTAS_PER_SM = 8               # split series until the grid covers this
MIN_SPLIT_POINTS = 4096       # never split a series finer than this
# the ring kernels' tile of the shared-memory path (csrc: kTile, kMaxPow)
TILE_POINTS = 16
MAX_POWERS = 2 * (K_PAD - 2) + 1

# the report sums, in the reference's SUM_* lane order
REPORT_NAMES = ("sw", "sy", "syy", "sf", "sff", "syf", "sse")

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_ACC_CODES = {torch.float32: 0, torch.float64: 1}

# launches per kernel since the last reset (read by chip_smoke.py and tests;
# "solve_small" counts kernels/solve.py's) and the identity map per (dtype,
# device), copied to the card synchronously (any stream may read it); the
# lock keeps both exact when fleet workers launch from threads
_LAUNCHES = {"moments_plain": 0, "moments_packed": 0,
             "moments_packed_ring": 0, "fused_report": 0, "solve_small": 0}
_IDENTITY: dict = {}
_LAUNCHES_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def launch_counts() -> dict:
    with _LAUNCHES_LOCK:
        return dict(_LAUNCHES)


def _count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        _LAUNCHES[name] += 1


def _identity_map(x) -> tuple:
    key = (x.dtype, x.device)
    with _LAUNCHES_LOCK:
        if key not in _IDENTITY:
            _IDENTITY[key] = tuple(torch.tensor(v, dtype=x.dtype,
                                                device=x.device)
                                   for v in (0, 1))
        return _IDENTITY[key]


def packing_factor(degree: int) -> int:
    """How many series the reference packs into one 128-row tile; the plan
    layer keeps its rule (pack when this is >= 2)."""
    return K_PAD // (degree + 2)


def splits(b: int, n: int, tasks_per_cta: int, sm_count: int) -> int:
    """Splits per series so that B·S tasks fill CTAS_PER_SM CTAs on every
    SM, without cutting a series below MIN_SPLIT_POINTS points.  Depends
    only on the shapes and the card, so a rerun gives the same bits."""
    want = CTAS_PER_SM * sm_count * tasks_per_cta
    s = max(1, -(-want // max(b, 1)))
    return max(1, min(s, -(-n // MIN_SPLIT_POINTS)))


# ------------------------------------------------------------ plain versions
def moments_block_plain(x, y, w, degree: int, accum_dtype=torch.float32,
                        shift=None, scale=None):
    """(B, K, K) extended Gram (W·w)Wᵀ with W = [x⁰…xᵐ, y], built in the
    accumulation dtype by iterated multiply; with ``shift`` and ``scale``
    on ``Domain.apply(x)``."""
    if shift is not None:
        from repro_torch.core.basis import Domain
        x = Domain(shift, scale).apply(x)
    x = x.to(accum_dtype)
    y = y.to(accum_dtype)
    rows = [torch.ones_like(x)]
    for _ in range(degree):
        rows.append(rows[-1] * x)
    rows.append(y)
    wmat = torch.stack(rows, dim=-2)                      # (B, K, n)
    lhs = wmat if w is None else wmat * w.to(accum_dtype)[:, None, :]
    return torch.einsum("bkn,bjn->bkj", lhs, wmat)


def fused_report_plain(x, y, w, coeffs, accum_dtype=torch.float32):
    """(B, 7) report sums: Horner f, e = y - f, then Σw, Σwy, Σwy², Σwf,
    Σwf², Σwyf, Σwe² per series."""
    x = x.to(accum_dtype)
    y = y.to(accum_dtype)
    c = coeffs.to(accum_dtype)
    m = c.shape[-1] - 1
    f = torch.zeros_like(x) + c[:, m, None]
    for k in range(m - 1, -1, -1):
        f = f * x + c[:, k, None]
    e = y - f
    w = torch.ones_like(x) if w is None else w.to(accum_dtype)
    return torch.stack([w.sum(-1), (w * y).sum(-1), (w * y * y).sum(-1),
                        (w * f).sum(-1), (w * f * f).sum(-1),
                        (w * y * f).sum(-1), (w * e * e).sum(-1)], dim=-1)


# ---------------------------------------------------------------- launchers
def _check_inputs(x, y, w, accum_dtype):
    if x.ndim != 2 or y.shape != x.shape:
        raise ValueError(f"expected x, y of one (B, n) shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _IN_CODES or y.dtype != x.dtype:
        raise TypeError(f"x/y dtypes {x.dtype}/{y.dtype}: one of "
                        f"{list(_IN_CODES)} expected for both")
    if accum_dtype not in _ACC_CODES:
        raise TypeError(f"accum_dtype {accum_dtype}: one of "
                        f"{list(_ACC_CODES)} expected")
    tensors = [x, y] + ([] if w is None else [w])
    if w is not None and (w.shape != x.shape or w.dtype != accum_dtype):
        raise ValueError("weights must match x's shape, in accum_dtype")
    for t in tensors:
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError("all inputs must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def map_error(x, shift, scale) -> Exception | None:
    """What the launchers raise for this domain map (None: they take it).
    The map is both or neither of shift and scale, each a 0-d tensor of
    x's dtype on x's device."""
    if shift is None and scale is None:
        return None
    if shift is None or scale is None:
        return ValueError("a domain map needs both shift and scale")
    for name, t in (("shift", shift), ("scale", scale)):
        if not isinstance(t, torch.Tensor) or t.ndim != 0:
            return ValueError(f"{name} must be a 0-d tensor, got "
                              f"{getattr(t, 'shape', type(t).__name__)}")
        if t.dtype != x.dtype:
            return TypeError(f"{name} dtype {t.dtype}: x's {x.dtype} "
                             "expected")
        if t.device != x.device:
            return ValueError(f"{name} on {t.device}: x's device "
                              f"{x.device} expected")
    return None


def _check_map(x, shift, scale) -> None:
    err = map_error(x, shift, scale)
    if err is not None:
        raise err


def _raise_on(err: int, what: str) -> None:
    if err:
        from repro_torch.kernels import build
        msg = build.library().repro_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ring_blocks(n: int, s: int, block_n: int) -> int:
    """Ring blocks of the longest (series, split) task."""
    chunk = -(-n // s)
    return -(-chunk // block_n)


@spans.span("kernels.launch")
def _launch_moments(layout: int, name: str, x, y, w, degree: int,
                    accum_dtype, compensated: bool, ring=None, shift=None,
                    scale=None):
    """Launch the moment kernel of ``layout`` (0 plain, 1 packed); with
    ``ring=(block_n, nbuf)`` the packed layout's ring form; mapping x by
    ``shift`` and ``scale`` (checked by the caller), else the identity."""
    from repro_torch.kernels import build
    _check_inputs(x, y, w, accum_dtype)
    if not 0 <= degree <= K_PAD - 2:
        raise ValueError(f"degree {degree} too large for the kernels "
                         f"(degree + 2 <= {K_PAD})")
    b, n = x.shape
    k = degree + 2
    nsum = 3 * degree + 3
    packed_cta = layout == 1 and degree <= REGISTER_MAX_DEGREE
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    s = splits(b, n, SERIES_PER_PACKED_CTA if packed_cta else 1, sm_count)
    part_hi = torch.empty((b, s, nsum), dtype=accum_dtype, device=x.device)
    part_lo = torch.empty_like(part_hi) if compensated else None
    out = torch.empty((b, k, k), dtype=accum_dtype, device=x.device)
    if shift is None:
        shift, scale = _identity_map(x)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        common = (x.data_ptr(), y.data_ptr(), _ptr(w), b, n, degree, s)
        tail = (part_hi.data_ptr(), _ptr(part_lo), out.data_ptr(), stream,
                shift.data_ptr(), scale.data_ptr())
        codes = (_IN_CODES[x.dtype], _ACC_CODES[accum_dtype],
                 int(compensated))
        if ring is None:
            err = lib.repro_moments(layout, *codes, *common, *tail)
        else:
            block_n, nbuf = ring
            # the reference's cap: no more slots than the task has blocks
            blocks = _ring_blocks(n, s, block_n)
            nbuf = min(nbuf, blocks) if blocks > 1 else 2
            err = lib.repro_moments_ring(*codes, *common, block_n, nbuf,
                                         *tail)
    _raise_on(err, name)
    _count_launch(name)
    return out


def moments_plain(x, y, w=None, *, degree: int, accum_dtype=torch.float32,
                  compensated: bool = False, shift=None,
                  scale=None) -> torch.Tensor:
    """(B, K, K) extended Grams; one CTA per (series, n-split); with
    ``shift`` and ``scale`` those of ``Domain(shift, scale).apply(x)``.  On
    a CPU tensor: the plain version."""
    _check_map(x, shift, scale)
    if x.device.type == "cpu":
        return moments_block_plain(x, y, w, degree, accum_dtype, shift, scale)
    return _launch_moments(0, "moments_plain", x, y, w, degree, accum_dtype,
                           compensated, shift=shift, scale=scale)


def moments_packed(x, y, w=None, *, degree: int, accum_dtype=torch.float32,
                   compensated: bool = False, shift=None,
                   scale=None) -> torch.Tensor:
    """(B, K, K) extended Grams; one warp per (series, n-split), eight per
    CTA (above degree 14 the shared-memory kernel, one CTA per task); with
    ``shift`` and ``scale`` those of ``Domain(shift, scale).apply(x)``.  On
    a CPU tensor: the plain version."""
    _check_map(x, shift, scale)
    if x.device.type == "cpu":
        return moments_block_plain(x, y, w, degree, accum_dtype, shift, scale)
    return _launch_moments(1, "moments_packed", x, y, w, degree, accum_dtype,
                           compensated, shift=shift, scale=scale)


def _check_ring(block_n: int, nbuf: int) -> None:
    """The ring's arguments: block_n a positive multiple of 32 (a lane
    keeps its points), nbuf >= 2."""
    if block_n < 32 or block_n % 32:
        raise ValueError(f"block_n={block_n}: a positive multiple of 32")
    if nbuf < 2:
        raise ValueError(f"nbuf={nbuf}: the ring needs >= 2 slots")


def moments_packed_ring(x, y, w=None, *, degree: int, block_n: int,
                        nbuf: int, accum_dtype=torch.float32,
                        compensated: bool = False, shift=None,
                        scale=None) -> torch.Tensor:
    """(B, K, K) extended Grams, bit-equal to ``moments_packed``, with the
    loads streamed through an ``nbuf``-slot shared-memory ring in blocks
    of ``block_n`` points (``nbuf`` is capped at the blocks of the longest
    task); the map as ``moments_packed`` takes it.  On a CPU tensor: the
    plain version."""
    _check_ring(block_n, nbuf)
    _check_map(x, shift, scale)
    if x.device.type == "cpu":
        return moments_block_plain(x, y, w, degree, accum_dtype, shift, scale)
    return _launch_moments(1, "moments_packed_ring", x, y, w, degree,
                           accum_dtype, compensated, ring=(block_n, nbuf),
                           shift=shift, scale=scale)


def fused_report(x, y, w, coeffs, *, accum_dtype=torch.float32
                 ) -> torch.Tensor:
    """(B, 7) report sums in ``REPORT_NAMES`` order; ``coeffs``: (B, m+1)
    monomial coefficients in accum_dtype.  On a CPU tensor: the plain
    version."""
    if x.device.type == "cpu":
        return fused_report_plain(x, y, w, coeffs, accum_dtype)
    from repro_torch.kernels import build
    _check_inputs(x, y, w, accum_dtype)
    b, n = x.shape
    degree = coeffs.shape[-1] - 1
    if (coeffs.shape != (b, degree + 1) or coeffs.dtype != accum_dtype
            or coeffs.device != x.device or not coeffs.is_contiguous()):
        raise ValueError("coeffs must be a contiguous (B, m+1) tensor in "
                         "accum_dtype on x's device")
    if degree + 1 > K_PAD:
        raise ValueError(f"degree {degree} too large for K_PAD={K_PAD}")
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    s = splits(b, n, 1, sm_count)
    nsum = len(REPORT_NAMES)
    part = torch.empty((b, s, nsum), dtype=accum_dtype, device=x.device)
    out = torch.empty((b, nsum), dtype=accum_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = build.library().repro_report(
            _IN_CODES[x.dtype], _ACC_CODES[accum_dtype], x.data_ptr(),
            y.data_ptr(), _ptr(w), coeffs.data_ptr(), b, n, degree, s,
            part.data_ptr(), out.data_ptr(), stream)
    _raise_on(err, "fused_report")
    _count_launch("fused_report")
    return out
