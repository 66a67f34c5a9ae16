"""Serving entry points on the card (port of ``repro.launch.serve``).

Fit serving, continuous batching over fixed slot pools:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Fault-tolerant fleet serving under chaos (replicated workers, seeded
fault injection, parity check against the fault-free run):

    PYTHONPATH=src python -m repro_torch.launch.serve --workload fleet \
        --workers 4 --chaos "crash=1,stall=1,poison=1" --assert-parity

Token serving (the zoo's decode engine; by default internlm2-1.8b at its
published size, 12 requests on 4 slots, as the reference launcher):

    PYTHONPATH=src python -m repro_torch.launch.serve --workload tokens
    PYTHONPATH=src python -m repro_torch.launch.serve --workload tokens \
        --smoke --device cpu

Any decoder arch of ``configs`` serves, the recurrent and hybrid ones too
(``--arch rwkv6-1.6b``, ``--arch zamba2-7b``); ``--arch whisper-base``
raises ``ValueError``: its prefill needs encoder frames besides tokens.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_fits(args) -> None:
    from repro_torch import obs as obs_lib
    from repro_torch.serve import FitServeConfig, FitServeEngine

    cfg = FitServeConfig(degree=args.degree, n_slots=args.slots,
                         buckets=tuple(args.buckets), ridge=1e-9,
                         engine=args.engine)
    obs = (obs_lib.Observability.on(device=args.device) if args.obs
           else obs_lib.NULL_OBS)
    engine = FitServeEngine(cfg, obs=obs, device=args.device)

    rng = np.random.default_rng(7)
    coef = rng.normal(0, 1, args.degree + 1)

    def make_request():
        # ragged lengths, log-uniform: most requests short, a heavy tail
        n = int(np.exp(rng.uniform(np.log(args.min_n), np.log(args.max_n))))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (np.polyval(coef[::-1], x)
             + rng.normal(0, 0.1, n)).astype(np.float32)
        return engine.submit(x, y)

    execs = engine.warmup()   # runs every bucket's steps + the solves once

    reqs = [make_request() for _ in range(args.requests)]
    _sync(engine.device)
    t0 = time.perf_counter()
    engine.run()
    _sync(engine.device)
    dt = time.perf_counter() - t0
    recompiles = engine.compiled_executables() - execs
    done = sum(r.done for r in reqs)
    pts = sum(r.n for r in reqs)
    print(f"[serve-fits] {done}/{len(reqs)} fits, {pts} points in {dt:.2f}s "
          f"({done / dt:.1f} fits/s, {pts / dt / 1e6:.2f} Mpts/s, "
          f"{execs} executables, {recompiles} recompiles after warmup)")
    for r in reqs[:3]:
        print(f"  req {r.uid}: n={r.n} R={r.r:.4f} sse={r.sse:.3g} "
              f"coeffs={np.round(r.coeffs, 3)}")
    if done != len(reqs):
        raise RuntimeError(f"{len(reqs) - done} requests not served")
    if recompiles:
        raise RuntimeError(f"{recompiles} new executables after warmup")
    if args.obs:
        snap = obs.metrics.snapshot()
        lat = obs.metrics.histogram("fit_latency_steps")
        print(f"[serve-fits] obs: submitted="
              f"{snap['counters']['submitted']} completed="
              f"{snap['counters']['completed']} latency p50/p99 = "
              f"{lat.quantile(0.5):.0f}/{lat.quantile(0.99):.0f} steps")
        print(obs.metrics.render_prometheus(), end="")


def serve_fleet(args) -> None:
    """Drive the fault-tolerant fleet twice — fault-free, then under the
    requested chaos schedule — and report recovery numbers (and, with
    ``--assert-parity``, enforce the bitwise chaos-parity invariant).

    ``--obs`` turns on the observability layer for the chaos run: trace
    spans on the virtual tick clock, a live summary every ``--obs-every``
    ticks (mid-run sketch quantiles + SLO breach forecast), event-log
    invariant assertions, JSONL + Chrome-trace artifacts under
    ``--obs-dir``, and a Prometheus text exposition."""
    from repro_torch.runtime.chaos import ChaosSchedule
    from repro_torch.serve import FitServeConfig, FleetConfig, FitFleet

    rng = np.random.default_rng(7)
    coef = rng.normal(0, 1, args.degree + 1)
    series = []
    for _ in range(args.requests):
        n = int(np.exp(rng.uniform(np.log(args.min_n), np.log(args.max_n))))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (np.polyval(coef[::-1], x)
             + rng.normal(0, 0.1, n)).astype(np.float32)
        series.append((x, y))

    def run(chaos, obs=False):
        cfg = FleetConfig(fit=FitServeConfig(degree=args.degree),
                          n_workers=args.workers, chaos=chaos,
                          straggler_threshold=2.0, trace=obs,
                          slo_p99=args.slo_p99 if obs else None)
        fleet = FitFleet(cfg, device=args.device)
        _sync(fleet.device)
        t0 = time.perf_counter()
        reqs = [fleet.submit(x, y) for x, y in series]
        if obs:
            for _ in range(50_000):
                if not fleet.pending:
                    break
                fleet.step()
                if fleet.tick % args.obs_every == 0:
                    _obs_live_line(fleet)
            else:
                raise RuntimeError(f"{fleet.pending} requests pending")
        else:
            fleet.run(max_ticks=50_000)
        _sync(fleet.device)
        dt = time.perf_counter() - t0
        return fleet, reqs, dt

    base_fleet, base, base_dt = run(None)
    q0 = base_fleet.latency_quantiles()
    print(f"[fleet] fault-free on {base_fleet.device}: "
          f"{base_fleet.stats['completed']}/{len(base)} fits in "
          f"{base_dt:.2f}s over {base_fleet.tick} ticks (p50 "
          f"{q0['p50']:.0f} / p99 {q0['p99']:.0f} ticks)")

    chaos = ChaosSchedule.parse(args.chaos, args.chaos_seed, args.workers,
                                horizon=args.chaos_horizon)
    fleet, reqs, dt = run(chaos, obs=args.obs)
    s, q = fleet.stats, fleet.latency_quantiles()
    lost = [r.uid for r in reqs if not r.done or r.failed]
    print(f"[fleet] chaos '{args.chaos}' (seed {args.chaos_seed}): "
          f"{s['completed']}/{len(reqs)} fits in {dt:.2f}s over "
          f"{fleet.tick} ticks (p50 {q['p50']:.0f} / p99 {q['p99']:.0f})")
    print(f"[fleet]   lost={len(lost)} deaths={s['worker_deaths']} "
          f"revivals={s['revivals']} replays={s['replays']} "
          f"hedges={s['hedges']} ({s['hedge_wins']}W/{s['hedge_losses']}L) "
          f"resends={s['resends']} poisoned={s['poisoned']} "
          f"shed={s['shed']} queue_hwm="
          f"{fleet.metrics.gauge('queue_depth').hwm:.0f}")
    if lost:
        raise RuntimeError(f"lost requests: {lost}")
    if args.obs:
        _obs_finish(args, fleet, reqs)
    if args.assert_parity:
        for b, c in zip(base, reqs):
            if c.count != b.count:
                raise RuntimeError(f"req {c.uid}: count {c.count} != "
                                   f"{b.count} in the fault-free run")
            np.testing.assert_array_equal(c.coeffs, b.coeffs)
        print(f"[fleet] parity OK: {len(reqs)} requests bit-identical "
              "to the fault-free run")


def _obs_live_line(fleet) -> None:
    q = fleet.latency_quantiles()
    line = (f"[obs] tick {fleet.tick:>5}  completed="
            f"{fleet.stats['completed']:<4} pending={fleet.pending:<4} "
            f"p50/p99={q['p50']:.0f}/{q['p99']:.0f}")
    for ref, rep in fleet.slo.report(fleet.tick).items():
        eta = rep["breach_eta_ticks"]
        line += (f"  slo[{ref}<{rep['threshold']:g}]: "
                 f"eta={'-' if eta is None else eta}")
    print(line)


def _obs_finish(args, fleet, reqs) -> None:
    """Check the trace invariants, write the artifacts, print the
    exposition."""
    import os

    from repro_torch import obs as obs_lib

    events = fleet.tracer.events
    obs_lib.assert_valid(events)
    # every replay the request surfaced is annotated in its span chain
    for r in reqs:
        names = fleet.tracer.names_for(r.uid)
        if names.count("replay") != r.replays:
            raise RuntimeError(f"req {r.uid}: {r.replays} replays, trace "
                               f"{names}")
        if r.hedged and "hedge" not in names:
            raise RuntimeError(f"req {r.uid}: hedged, trace {names}")
    terminal = sum(1 for e in events
                   if e["ph"] == "i" and e["name"] in obs_lib.trace.TERMINAL)
    print(f"[obs] trace OK: {len(events)} events, {terminal} terminal "
          f"spans, invariants hold")
    os.makedirs(args.obs_dir, exist_ok=True)
    jsonl = os.path.join(args.obs_dir, "fleet_trace.jsonl")
    chrome = os.path.join(args.obs_dir, "fleet_trace.chrome.json")
    fleet.tracer.export_jsonl(jsonl)
    fleet.tracer.export_chrome(chrome)
    with open(os.path.join(args.obs_dir, "fleet_metrics.prom"), "w") as f:
        f.write(fleet.metrics.render_prometheus())
    print(f"[obs] artifacts: {jsonl}, {chrome}")
    print(fleet.metrics.render_prometheus(), end="")


def serve_tokens(args) -> dict:
    """Serve ``--requests`` prompts through the token ServeEngine on a
    model drawn from seed 0, as the reference launcher does; returns the
    run's counts and its host-clock time."""
    import torch

    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.models import get_model
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.arch}: the token engine takes token prompts, and an "
            "encoder-decoder's prefill needs frames as well (as in the "
            "reference's engine)")
    dev = resolve_device(args.device)
    model = get_model(cfg)
    params = model.init_params(0, device=dev)
    engine = ServeEngine(model, params,
                         EngineConfig(n_slots=args.slots,
                                      max_len=args.max_len),
                         generator=torch.Generator(device=dev).manual_seed(7))

    rng = np.random.default_rng(7)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(3, cfg.vocab_size - 1, 8 + i % 8).tolist()
        reqs.append(engine.submit(prompt, max_new_tokens=args.max_new,
                                  temperature=0.8))
    _sync(dev)
    t0 = time.perf_counter()
    engine.run()
    _sync(dev)
    dt = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out_tokens) for r in reqs)
    out = {"arch": cfg.arch, "device": str(dev), "requests": len(reqs),
           "done": done, "tokens": toks, "wall_s": dt, "tok_per_s": toks / dt,
           **engine.stats, "engine": engine, "reqs": reqs}
    print(f"[serve] {cfg.arch} on {dev}: {done}/{len(reqs)} finished, "
          f"{toks} tokens in {dt:.1f}s ({toks / dt:.1f} tok/s); "
          f"{out['prefill_tokens']} prompt tokens, "
          f"{out['decode_steps']} decode steps, "
          f"peak pooled length {out['peak_len']}/{args.max_len}")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {len(r.out_tokens)} tokens "
              f"{r.out_tokens[:10]}...")
    if done != len(reqs):
        raise RuntimeError(f"{len(reqs) - done} requests not finished")
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("fits", "fleet", "tokens"),
                    default="fits")
    # per-workload defaults: fits churns 200 requests on 8 slots, the
    # fleet 32, tokens decodes 12 on 4 slots
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--buckets", type=int, nargs="+", default=[256, 2048])
    ap.add_argument("--min-n", type=int, default=16)
    ap.add_argument("--max-n", type=int, default=8192)
    ap.add_argument("--engine", default="auto",
                    help="engine.plan_fit path: auto/reference/kernel/...")
    # fleet knobs
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--chaos", default="crash=1,stall=1",
                    help='fault counts, e.g. "crash=1,stall=1,poison=2"')
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-horizon", type=int, default=8,
                    help="fault ticks are drawn in [1, horizon); keep it "
                         "below the run length or nothing fires")
    ap.add_argument("--assert-parity", action="store_true",
                    help="require bitwise parity with the fault-free run")
    # observability knobs
    ap.add_argument("--obs", action="store_true",
                    help="metrics + trace spans (fits: counters, latency "
                         "sketch, Prometheus exposition; fleet: the SLO "
                         "board, live summary, invariant checks and "
                         "JSONL/Chrome artifacts too)")
    ap.add_argument("--obs-dir", default="obs_artifacts",
                    help="where the fleet's --obs writes trace/exposition "
                         "artifacts")
    ap.add_argument("--obs-every", type=int, default=64,
                    help="live summary cadence in virtual ticks")
    ap.add_argument("--slo-p99", type=float, default=200.0,
                    help="latency p99 SLO threshold (ticks) the SLO "
                         "monitor forecasts breaches against")
    # token-serving knobs
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    return ap


def run(argv=None):
    """Parse ``argv``, fill the workload's defaults and serve it; returns
    what the workload returns (``serve_tokens``' counts and times)."""
    args = parser().parse_args(argv)
    if args.workload == "fleet":
        args.requests = 32 if args.requests is None else args.requests
        return serve_fleet(args)
    if args.workload == "tokens":
        args.requests = 12 if args.requests is None else args.requests
        args.slots = 4 if args.slots is None else args.slots
        return serve_tokens(args)
    args.requests = 200 if args.requests is None else args.requests
    args.slots = 8 if args.slots is None else args.slots
    return serve_fits(args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
