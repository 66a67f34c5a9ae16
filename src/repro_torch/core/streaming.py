"""Streaming LSE fitting with O(1) state: additive moments over time (port
of ``repro.core.streaming``).

Because the paper's sufficient statistics (power sums / Gram) are
additive, a fit over an unbounded stream needs only the running
``Moments``, no history buffer.  An exponential-forgetting variant (decay
γ) solves the γ-weighted least-squares problem exactly.

A ``StreamState`` may carry a ``FitSpec`` (create it with
``spec.streaming()``): ``update`` then applies the spec's engine, basis,
pinned domain and, for ``method="irls"``, per-chunk robust reweighting
against the running fit; ``api.stream_result`` reads the spec's answer
(fixed fit, degree search, or moment-space LSPIA) out of the state.

Every ``update`` plans its moment pass with the chunk's device, so a
stream on the card takes the CUDA kernels (``moments_packed`` for a batch
of series, ``moments_plain`` for one long series).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import moments as moments_lib
from repro_torch.core import solve as solve_lib
from repro_torch.device import as_tensor, resolve_device
from repro_torch.obs import spans

_FIELDS = tuple(f.name for f in dataclasses.fields(moments_lib.Moments))


@dataclasses.dataclass(frozen=True)
class StreamState:
    """Running moments (+ optional k-fold partials for online selection).

    ``cv_folds > 0`` at creation adds per-fold partial moments (leading
    fold axis): each chunk's moments are computed once and folded into
    BOTH the total and one fold, round-robin per chunk (``fold_index``, a
    host integer), so ``current_selection()`` runs moment-space k-fold CV
    with zero re-reads of the stream.  ``spec`` is the optional
    ``FitSpec`` the state was created for.  ``host_decay`` is ``decay`` as
    a host float, so ``update`` tells γ = 1 without reading the device;
    ``None`` (a state built without it) folds as if γ < 1, with the same
    bits."""

    moments: moments_lib.Moments
    decay: torch.Tensor   # scalar in (0, 1] of the state's dtype
    fold_moments: moments_lib.Moments | None = None  # (k, ...batch)
    fold_index: int | None = None                    # next fold
    spec: object = None
    host_decay: float | None = None

    @staticmethod
    def create(degree: int, batch: tuple[int, ...] = (), *,
               decay: float = 1.0, dtype=torch.float32, cv_folds: int = 0,
               spec=None, device=None) -> "StreamState":
        """A zero state on ``device`` (``None`` means CUDA)."""
        dev = resolve_device(device)
        batch = tuple(batch)
        folds = (moments_lib.Moments.zeros(degree, (cv_folds,) + batch,
                                           dtype, dev)
                 if cv_folds >= 2 else None)
        idx = 0 if cv_folds >= 2 else None
        # γ filled on the device (no host-to-device copy) and on the host
        return StreamState(moments_lib.Moments.zeros(degree, batch, dtype,
                                                     dev),
                           torch.full((), decay, dtype=dtype, device=dev),
                           folds, idx, spec,
                           float(torch.full((), decay, dtype=dtype)))

    @property
    def device(self) -> torch.device:
        return self.moments.gram.device

    def snapshot(self) -> dict:
        """Host-side O(m²) copy of the running state, as plain numpy in
        the reference's layout (a reference snapshot restores here and the
        other way round).  The ``spec`` is not captured: the restoring
        side supplies it.  ``restore(snapshot())`` round-trips bit for
        bit."""
        def host(m):
            return {f: getattr(m, f).detach().cpu().numpy() for f in _FIELDS}
        snap = host(self.moments)
        snap["decay"] = self.decay.detach().cpu().numpy()
        if self.fold_moments is not None:
            snap["folds"] = host(self.fold_moments)
            snap["fold_index"] = np.asarray(self.fold_index, np.int32)
        return snap

    @staticmethod
    def restore(snap: dict, *, spec=None, device=None) -> "StreamState":
        """Rebuild a ``StreamState`` from a ``snapshot()`` dict on
        ``device`` (``None`` means CUDA); ``spec`` re-attaches the
        ``FitSpec`` the state accumulates under; ``host_decay`` comes
        from the snapshot's ``decay``."""
        dev = resolve_device(device)

        def tensor(a):
            return torch.from_numpy(np.array(a, copy=True)).to(dev)

        def mk(d):
            return moments_lib.Moments(*(tensor(d[f]) for f in _FIELDS))
        folds = mk(snap["folds"]) if "folds" in snap else None
        idx = int(snap["fold_index"]) if "fold_index" in snap else None
        return StreamState(mk(snap), tensor(snap["decay"]), folds, idx, spec,
                           float(np.asarray(snap["decay"])))

    def current_selection(self, *, criterion: str | None = None,
                          ridge: float = 0.0, solver: str = "auto",
                          fallback: str | None = "svd",
                          basis: str = basis_lib.MONOMIAL):
        """The running best degree (and the whole scored ladder) so far,
        from the O(m²) state: AIC/AICc/BIC/GCV always, k-fold CV when the
        state has fold partials.  ``criterion`` defaults to "cv" when
        folds exist, else "aicc"."""
        from repro_torch import select as select_lib
        m = self.moments.regularized(ridge) if ridge else self.moments
        if criterion is None:
            criterion = "cv" if self.fold_moments is not None else "aicc"
        if criterion == "cv" and self.fold_moments is None:
            raise ValueError("criterion='cv' needs StreamState.create(..., "
                             "cv_folds=k)")
        sweep = select_lib.sweep_from_moments(
            m, fold_moments=self.fold_moments,
            score_moments=self.moments if ridge else None, solver=solver,
            fallback=fallback, basis=basis)
        return select_lib.selection_from_sweep(sweep, criterion, basis=basis,
                                               solver=solver,
                                               fallback=fallback)


def _spec_solver(spec, degree: int, dtype) -> tuple[str, str | None]:
    """The spec's (solver, fallback) for a moment solve."""
    pol = spec.numerics
    solver = pol.solver
    if solver == "auto":
        solver = solve_lib.select_solver(degree, dtype, basis=spec.basis,
                                         normalized=spec.domain is not None
                                         or pol.normalize)
    return solver, pol.fallback


def _scaled(m: moments_lib.Moments, g: torch.Tensor) -> moments_lib.Moments:
    """Every field but ``count`` times the decay factor g."""
    return dataclasses.replace(moments_lib.map_fields(lambda a: a * g, m),
                               count=m.count)


def _unit_decay(state: StreamState) -> bool:
    """γ = 1, known on the host: nothing decays."""
    return state.host_decay == 1.0


def _decay_factor(state: StreamState, n: int) -> torch.Tensor:
    """γ**n as a tensor power in the state's dtype; the exponent is filled
    on the device, so no host-to-device copy drains its queue."""
    return state.decay ** torch.full((), n, dtype=state.decay.dtype,
                                     device=state.decay.device)


def streaming_irls_weights(state: StreamState, xt: torch.Tensor,
                           y: torch.Tensor, base_w: torch.Tensor, *,
                           solve, psi, sweeps: int, engine: str = "auto",
                           basis: str = basis_lib.MONOMIAL) -> torch.Tensor:
    """Single-pass streaming IRLS: robust ψ-weights for the incoming chunk.

    Sweep 0 weights the chunk's residuals against the RUNNING fit (where
    determined: count > degree); the remaining ``sweeps − 1`` sweeps
    re-accumulate the in-hand chunk against (decayed running state +
    chunk) and reweight.  Only the chunk is touched.  ``solve`` maps
    moments to coefficients and ``psi`` standardized residuals to weights:
    a spec-carrying stream passes its spec's (``_streaming_irls_weights``),
    the fit server its per-slot loss mix."""
    from repro_torch import engine as engine_lib
    from repro_torch.core import robust as robust_lib

    def reweight(coeffs):
        r = y - basis_lib.evaluate(coeffs, xt, basis=basis)
        return psi(r / robust_lib.chunk_scale(r, base_w, y))

    determined = (state.moments.count > state.moments.degree)[..., None]
    wr = torch.where(determined, reweight(solve(state.moments)),
                     torch.ones_like(xt))
    if sweeps > 1:
        old = state.moments
        if not _unit_decay(state):
            g = _decay_factor(state, xt.shape[-1])
            old = moments_lib.map_fields(lambda a: a * g, old)
        dec_w = _decay_weights(state, xt, base_w)
        plan = update_plan(state, tuple(xt.shape), xt.dtype, engine, basis)
        for _ in range(sweeps - 1):
            new = engine_lib.compute_moments(plan, xt, y, dec_w * wr)
            wr = reweight(solve(old + new))
    return wr


def _streaming_irls_weights(state: StreamState, xt: torch.Tensor,
                            y: torch.Tensor,
                            base_w: torch.Tensor | None) -> torch.Tensor:
    """``streaming_irls_weights`` under the state's spec: its loss and
    tuning, its numerics policy and ridge for the solves."""
    from repro_torch.core import robust as robust_lib
    spec = state.spec
    opts = spec.irls
    cval = robust_lib.resolve_tuning(opts.loss, opts.c)
    solver, fallback = _spec_solver(spec, state.moments.degree,
                                    state.moments.gram.dtype)

    def solve(m):
        if spec.ridge:
            m = m.regularized(spec.ridge)
        c, _, _ = solve_lib.solve_with_fallback(
            m.gram, m.vty, method=solver, fallback=fallback,
            cond_cap=spec.numerics.cond_cap)
        return c

    return streaming_irls_weights(
        state, xt, y, torch.ones_like(xt) if base_w is None else base_w,
        solve=solve,
        psi=lambda u: robust_lib.robust_weights(u, opts.loss, cval),
        sweeps=opts.stream_sweeps, engine=spec.engine, basis=spec.basis)


def update_plan(state: StreamState, shape: tuple[int, ...], dtype,
                engine: str = "auto", basis: str = basis_lib.MONOMIAL, *,
                backend: str | None = None):
    """The ``FitPlan`` ``update`` runs for a chunk of this shape and dtype
    on the state's device (the spec's basis and engine win over the
    arguments, as in ``update``).  ``backend="cuda"`` plans as if the
    state lived on the card (what-if planning)."""
    from repro_torch import engine as engine_lib
    spec = state.spec
    if spec is not None:
        basis = spec.basis
        if engine == "auto":
            engine = spec.engine
    return engine_lib.plan_fit(
        tuple(shape), state.moments.degree, basis=basis, dtype=dtype,
        weighted=True, engine=engine, accum_dtype=state.moments.gram.dtype,
        device=state.device, backend=backend)


@spans.span("stream.update")
def update(state: StreamState, x, y, *, weights=None,
           basis: str = basis_lib.MONOMIAL,
           engine: str = "auto",
           use_kernel: bool | None = None) -> StreamState:
    """Fold a new chunk (..., n) into the running moments.

    With decay γ, previous weighted mass is multiplied by γ**n_new (a
    tensor power in the state's dtype), giving exact exponentially
    weighted least squares (the newest point has weight 1); at γ = 1
    nothing is rescaled and a chunk without weights takes the unweighted
    moment pass.  ``count`` is
    exempt from decay: it keeps the true number of contributing points,
    from the USER weights only.  The chunk is moved to the state's device;
    ``engine`` picks the accumulation path via ``engine.plan_fit``
    (planned on that device); ``use_kernel`` is a deprecated alias.  When the state carries a ``FitSpec``, the
    spec's basis/engine/domain win over the arguments and
    ``method="irls"`` reweights the chunk against the running fit
    first."""
    from repro_torch import engine as engine_lib
    engine = engine_lib.resolve_engine(engine, use_kernel)
    spec = state.spec
    dev = state.device
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    weights = None if weights is None else as_tensor(weights, dev)
    xt = x
    if spec is not None and spec.domain is not None:
        with spans.span("fit.domain"):
            xt = spec.domain_or(dtype=x.dtype, device=dev).apply(x)
    user_w = weights
    if spec is not None and spec.method == "irls":
        wr = _streaming_irls_weights(state, xt, y, weights)
        user_w = wr if weights is None else weights * wr
    w = _decay_weights(state, x, user_w)
    plan = update_plan(state, tuple(x.shape), x.dtype, engine, basis)
    new = engine_lib.compute_moments(plan, xt, y, w)
    new = moments_lib.map_fields(lambda a, ref: a.to(ref.dtype), new,
                                 state.moments)
    # count from the USER weights only: γ^age underflows to exactly 0 in
    # f32 past age ~700, and compute_moments counts nonzero combined
    # weights; decay must never make a point "not contribute" to count
    cdt = new.count.dtype
    true_count = (torch.full(tuple(x.shape[:-1]), x.shape[-1], dtype=cdt,
                             device=dev) if weights is None
                  else torch.sum(weights != 0, dim=-1).to(cdt))
    new = dataclasses.replace(
        new, count=torch.broadcast_to(true_count, new.count.shape))
    old, folds_old = state.moments, state.fold_moments
    if not _unit_decay(state):
        g = _decay_factor(state, x.shape[-1])
        old = _scaled(old, g)
        folds_old = None if folds_old is None else _scaled(folds_old, g)
    if state.fold_moments is None:
        return dataclasses.replace(state, moments=old + new)
    # the chunk's moments are in hand: fold them into one fold partial as
    # well (round-robin per chunk), so the k-fold CV state costs no extra
    # pass.  Decay applies to the fold partials as to the total.
    k = state.fold_moments.gram.shape[0]
    idx = state.fold_index % k

    def add_to_fold(f, a):
        out = f.clone()
        out[idx] = f[idx] + a
        return out
    folds = moments_lib.map_fields(add_to_fold, folds_old, new)
    return dataclasses.replace(state, moments=old + new, fold_moments=folds,
                               fold_index=state.fold_index + 1)


def _decay_weights(state: StreamState, x: torch.Tensor,
                   weights: torch.Tensor | None) -> torch.Tensor | None:
    """``weights`` times the chunk's decay ladder: the newest point gets
    γ⁰, the oldest γ^{n-1}.  At γ = 1 the ladder is all ones and is left
    out (``weights`` come back as they are, ``None`` for none) wherever
    that hands the moment pass the same operands in the same dtypes: x,
    and the weights if any, in the state's dtype."""
    acc = state.moments.gram.dtype
    if (_unit_decay(state) and x.dtype == acc
            and (weights is None or weights.dtype == acc)):
        return weights
    w = torch.broadcast_to(
        moments_lib.decay_ladder(x.shape[-1], state.decay, x.dtype,
                                 x.device), x.shape)
    return w if weights is None else w * weights


def current_fit(state: StreamState, *, method: str | None = None,
                solver: str = "auto", fallback: str | None = "svd",
                ridge: float = 0.0) -> fit_lib.Polynomial:
    """Solve the running normal equations.  ``ridge > 0`` adds λI
    (stabilizes early, nearly singular states).  The returned
    ``Polynomial.diagnostics`` carries the running state's κ(Gram) and
    whether the rescue fired.  ``method=`` is the legacy spelling of
    ``solver=``.  On a spec-carrying state the spec supplies the defaults:
    its numerics policy (when ``solver`` was left "auto"), its ridge (when
    ``ridge`` was left 0), and its basis/pinned domain."""
    spec = state.spec
    basis = basis_lib.MONOMIAL
    dom = None
    normalized = False
    cond_cap = None
    if spec is not None:
        basis = spec.basis
        dom = spec.domain_or(dtype=state.moments.gram.dtype,
                             device=state.device)
        normalized = spec.domain is not None
        cond_cap = spec.numerics.cond_cap
        if method is None and solver == "auto":
            solver, fallback = _spec_solver(spec, state.moments.degree,
                                            state.moments.gram.dtype)
        if not ridge:
            ridge = spec.ridge
    m = state.moments
    if ridge:
        m = m.regularized(ridge)
    return fit_lib.fit_from_moments(m, method=method, solver=solver,
                                    fallback=fallback, cond_cap=cond_cap,
                                    domain=dom, basis=basis,
                                    normalized=normalized)


def current_sse(state: StreamState,
                poly: fit_lib.Polynomial) -> torch.Tensor:
    return fit_lib.sse_from_moments(state.moments, poly.coeffs)


class AsyncChunkIngestor:
    """Barrier-free multi-source chunk ingestion into one ``StreamState``.

    Moments are additive and order-independent, so any source's
    next-in-sequence chunk folds in when it arrives; ``offer`` never
    blocks on another source.  Per-source sequence numbers make delivery
    idempotent (a retried chunk is acknowledged, never re-accumulated) and
    a small reorder buffer absorbs out-of-order arrival within one source.
    ``fresh()`` is True while no source lags the lead source by more than
    ``staleness`` chunks.  Requires ``decay == 1.0``: forgetting is
    order-dependent."""

    def __init__(self, state: StreamState, n_sources: int,
                 staleness: int = 4, reorder_window: int = 8,
                 metrics=None):
        if n_sources < 1:
            raise ValueError(f"n_sources must be >= 1, got {n_sources}")
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        if float(state.decay) != 1.0:
            raise ValueError(
                "barrier-free folding is order-independent accumulation; "
                f"decay={float(state.decay)} is order-dependent — use a "
                "non-forgetting state")
        self.state = state
        self.n_sources = n_sources
        self.staleness = staleness
        self.reorder_window = reorder_window
        self.applied = [0] * n_sources          # per-source seq watermark
        self._held: list[dict[int, tuple]] = [{} for _ in range(n_sources)]
        self.duplicates = 0
        self.buffered = 0
        self.overflowed = 0
        # optional obs.MetricsRegistry: mirrors the attribute counters and
        # keeps a per-readout source-lag gauge (hwm = worst lag seen)
        if metrics is None:
            from repro_torch.obs.metrics import NULL_REGISTRY
            metrics = NULL_REGISTRY
        self.metrics = metrics
        self._m_applied = metrics.counter("chunks_applied")
        self._m_duplicates = metrics.counter("chunks_duplicate")
        self._m_buffered = metrics.counter("chunks_buffered")
        self._m_overflowed = metrics.counter("chunks_overflowed")
        self._g_lag = metrics.gauge("source_lag")

    def offer(self, source: int, seq: int, x, y, *,
              weights=None) -> bool:
        """Fold chunk ``seq`` (1-based, contiguous per source) of
        ``source``.  Returns True if the running state advanced; a
        duplicate is acknowledged idempotently and an early chunk is held
        in the reorder buffer."""
        if not 0 <= source < self.n_sources:
            raise ValueError(f"source {source} out of range "
                             f"[0, {self.n_sources})")
        mark = self.applied[source]
        if seq <= mark:
            self.duplicates += 1
            self._m_duplicates.inc()
            return False
        held = self._held[source]
        if seq > mark + 1:
            if seq - mark > self.reorder_window or seq in held:
                self.overflowed += seq not in held
                self.duplicates += seq in held
                (self._m_overflowed if seq not in held
                 else self._m_duplicates).inc()
                return False
            held[seq] = (x, y, weights)
            self.buffered += 1
            self._m_buffered.inc()
            return False
        self._apply(x, y, weights)
        self._m_applied.inc()
        self.applied[source] = seq
        # drain any successors the reorder buffer was holding
        while self.applied[source] + 1 in held:
            nxt = self.applied[source] + 1
            hx, hy, hw = held.pop(nxt)
            self._apply(hx, hy, hw)
            self._m_applied.inc()
            self.applied[source] = nxt
        self._g_lag.set(self.lag())
        return True

    def _apply(self, x, y, weights) -> None:
        self.state = update(self.state, x, y, weights=weights)

    def lag(self) -> int:
        """Chunks between the lead source and the most lagging one."""
        return max(self.applied) - min(self.applied)

    def stale_sources(self) -> list[int]:
        lead = max(self.applied)
        return [s for s in range(self.n_sources)
                if lead - self.applied[s] > self.staleness]

    def fresh(self) -> bool:
        """True while every source is within the staleness window."""
        return not self.stale_sources()
