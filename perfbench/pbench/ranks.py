"""The ranks of a cell on more than one card: start the peers, watch
them, stop them.

A cell whose ``chips`` is above 1 runs as that many processes, one to a
card.  Rank 0 is the harness's own process (``run.py``, on ``cuda:0``).
Its driver's ``run(ctx)`` calls ``start(ctx)`` when it chooses: after it
has built or loaded the program's kernels, so that no peer races it on a
cold build directory.  ``start`` spawns ``chips - 1`` peers, pins peer r
to ``cuda:r`` (the CPU with gloo where rank 0 runs on the CPU, as in the
tests), and joins them all into the default process group, on a
``TCPStore`` at 127.0.0.1 whose port rank 0 picks.  Each peer runs the
driver's ``peer(ctx)``, its ``ctx`` built like ``runner.Ctx`` (the cell,
the seed, the seconds, the device, ``cf`` and ``tr``) with ``rank`` and
``world`` besides; its standard output goes to standard error, so the
result line stays rank 0's.

A peer that exits with another code than 0 ends rank 0, from a watcher
thread, even while rank 0 waits in a collective: rank 0 names the peer's
rank, its exit code and the last lines of its error on standard error,
kills the other peers and exits with ``PEER_FAILED``, printing no result.
A peer whose rank 0 has died exits too.  ``Ranks.close()`` (the end of a
``with`` block) waits until every peer is past its ``peer(ctx)``, then
all ranks destroy the group together (NCCL's destroy waits for every
rank of the node); it takes each peer's report, joins the peers, kills
any left after ``JOIN_S``, and raises where a peer failed or had a
module of ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
loaded at its end.  The harness, not the driver, owns that end: once
``run(ctx)`` has returned, ``runner.run_cell`` calls ``close_open()``,
which closes a group the driver left open, so no result is printed
before the peers' checks.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import sys
import threading
import time
import traceback
from pathlib import Path

from pbench import cells, devtrace, runner

HOST = "127.0.0.1"
PEER_FAILED = 4           # rank 0's exit code when a peer failed
PARENT_GONE = 5           # a peer's exit code when rank 0 died
ERROR_LINES = 20          # of a failed peer's traceback, logged by rank 0
TIMEOUT_S = 120.0         # the store's and every collective's timeout
JOIN_S = 60.0             # what close() waits for the peers to end
DONE = "perfbench.peers_done"   # the store's count of peers past peer(ctx)

_OPEN: set = set()        # rank 0's groups not yet closed


@dataclasses.dataclass
class PeerCtx(runner.Ctx):
    """A peer's context: ``runner.Ctx`` with its rank and the world's
    size."""

    rank: int = 0
    world: int = 1


@dataclasses.dataclass
class _Spec:
    """What a peer needs to build its context and join the group."""

    cell: cells.Cell
    driver: str
    seed: int
    seconds: float
    trace: bool
    overrides: dict
    device: str
    backend: str
    rank: int
    world: int
    port: int


def _tail(text: str) -> str:
    return "\n".join(text.rstrip().splitlines()[-ERROR_LINES:])


def _loopback() -> None:
    """Both backends find their peers over the loopback device: the
    machine has no other network."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")


def _exit_with_parent(sentinel) -> None:
    multiprocessing.connection.wait([sentinel])
    runner.log("rank 0 is gone; this peer exits")
    os._exit(PARENT_GONE)


def _peer_main(spec: _Spec, conn) -> None:
    """A peer's process: load the driver, join the group, run the
    driver's ``peer(ctx)``, leave the group, report to rank 0 and exit."""
    parent = multiprocessing.parent_process()
    threading.Thread(target=_exit_with_parent, args=(parent.sentinel,),
                     daemon=True).start()
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    report = {"rank": spec.rank}
    code = 0
    try:
        driver = cells.load_module(Path(spec.driver),
                                   f"perfbench_peer_{spec.cell.system}")
        import torch
        import torch.distributed as dist
        device = torch.device(spec.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        store = dist.TCPStore(HOST, spec.port, spec.world, False,
                              timeout=timeout)
        dist.init_process_group(spec.backend, store=store, rank=spec.rank,
                                world_size=spec.world, timeout=timeout)
        ctx = PeerCtx(torch=torch, device=device, cell=spec.cell,
                      seed=spec.seed, seconds=spec.seconds,
                      trace=spec.trace, spans=devtrace.Spans(),
                      overrides=spec.overrides, rank=spec.rank,
                      world=spec.world)
        driver.peer(ctx)
        # NCCL's destroy waits for every rank of the node: leave together
        store.add(DONE, 1)
        dist.destroy_process_group()
    except BaseException:
        code = 1
        report["error"] = _tail(traceback.format_exc())
    report["forbidden"] = runner.forbidden_modules()
    conn.send(report)
    conn.close()
    sys.stderr.flush()
    os._exit(code)


@dataclasses.dataclass
class _Peer:
    rank: int
    proc: multiprocessing.Process
    conn: multiprocessing.connection.Connection
    report: dict | None = None

    def receive(self, timeout: float) -> dict | None:
        """The peer's report, where it has sent one within ``timeout``."""
        if self.report is None:
            try:
                if self.conn.poll(max(timeout, 0.0)):
                    self.report = self.conn.recv()
            except (EOFError, OSError):
                pass
        return self.report

    def describe(self) -> str:
        rep = self.receive(1.0) or {}
        err = rep.get("error")
        return (f"rank {self.rank} exited with code {self.proc.exitcode}"
                + (f"; the last lines of its error:\n{err}" if err
                   else "; it sent no error"))


class Ranks:
    """Rank 0's handle on its peers, closed by ``close()`` or at the end
    of a ``with`` block."""

    def __init__(self, peers: list, store):
        self._peers, self._store = peers, store
        self._closing = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name="perfbench-ranks")
        self._watcher.start()

    def __enter__(self) -> "Ranks":
        return self

    @property
    def pids(self) -> list[int]:
        return [p.proc.pid for p in self._peers]

    def __exit__(self, kind, value, tb) -> None:
        if kind is None:
            self.close()
            return
        # rank 0 failed: its peers may wait in a collective for it
        self._stop_watching()
        self._kill()
        for problem in self._shut_down():
            runner.log(problem)

    def _watch(self) -> None:
        live = {p.proc.sentinel: p for p in self._peers}
        while live and not self._closing.is_set():
            for s in multiprocessing.connection.wait(list(live),
                                                     timeout=0.2):
                peer = live.pop(s)
                peer.proc.join()
                if peer.proc.exitcode != 0 and not self._closing.is_set():
                    self._fail(peer)

    def _fail(self, peer: _Peer) -> None:
        runner.log(peer.describe())
        runner.log(f"a peer failed: rank 0 exits with code {PEER_FAILED} "
                   f"and no result")
        self._kill()
        sys.stderr.flush()
        os._exit(PEER_FAILED)

    def _kill(self) -> None:
        for p in self._peers:
            if p.proc.is_alive():
                p.proc.kill()
        for p in self._peers:
            p.proc.join(5.0)

    def _stop_watching(self) -> None:
        self._closing.set()
        self._watcher.join(5.0)

    def close(self) -> None:
        """Leave the group with the peers, take their reports, join them
        (killing any left after ``JOIN_S``), and raise where a peer failed
        or had a forbidden module loaded at its end."""
        self._stop_watching()
        problems = self._shut_down()
        if problems:
            raise RuntimeError("\n".join(problems))

    def _peers_done(self, deadline: float) -> bool:
        """Whether every peer got past its ``peer(ctx)``: wait for that
        until one has ended without it, or ``deadline``."""
        while time.monotonic() < deadline:
            if self._store.add(DONE, 0) >= len(self._peers):
                return True
            if any(p.proc.exitcode is not None for p in self._peers):
                break
            time.sleep(0.01)
        return self._store.add(DONE, 0) >= len(self._peers)

    def _shut_down(self) -> list[str]:
        _OPEN.discard(self)
        if self._store is None:
            return []
        deadline = time.monotonic() + JOIN_S
        together = self._peers_done(deadline)
        self._store = None
        import torch.distributed as dist
        # without every peer, NCCL's destroy would wait for ever; the
        # process ends soon after, and the group with it
        if together and dist.is_initialized():
            dist.destroy_process_group()
        for p in self._peers:
            p.receive(deadline - time.monotonic())
        for p in self._peers:
            p.proc.join(max(deadline - time.monotonic(), 0.0))
        left = [p.rank for p in self._peers if p.proc.is_alive()]
        self._kill()
        problems = []
        if left:
            problems.append(f"ranks {left} did not end within "
                            f"{JOIN_S} s and were killed")
        problems += [p.describe() for p in self._peers
                     if p.rank not in left and p.proc.exitcode != 0]
        bad = {p.rank: p.report["forbidden"] for p in self._peers
               if p.report and p.report.get("forbidden")}
        if bad:
            problems.append(
                "modules of jax or the JAX package loaded on peers: "
                + "; ".join(f"rank {r}: {', '.join(m)}"
                            for r, m in sorted(bad.items())))
        return problems


def start(ctx) -> Ranks:
    """Spawn the cell's ``chips - 1`` peers, each running ``peer(ctx)`` of
    the cell's system driver, and join rank 0 to the group with them.
    Call from rank 0's ``run(ctx)``, after the program's kernels are
    built."""
    import torch.distributed as dist
    world = ctx.cell.chips
    if world < 2:
        raise ValueError(f"{ctx.cell.name} runs on {world} card: no peers")
    on_card = ctx.device.type == "cuda"
    if on_card and ctx.device.index not in (None, 0):
        raise ValueError(f"rank 0 runs on cuda:0, not {ctx.device}")
    backend = "nccl" if on_card else "gloo"
    driver = str(cells.BENCH / "systems" / f"{ctx.cell.system}.py")
    _loopback()
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(HOST, 0, world, True, timeout=timeout,
                          wait_for_workers=False)
    mp = multiprocessing.get_context("spawn")
    peers = []
    for r in range(1, world):
        spec = _Spec(cell=ctx.cell, driver=driver, seed=ctx.seed,
                     seconds=ctx.seconds, trace=ctx.trace,
                     overrides=ctx.overrides,
                     device=f"cuda:{r}" if on_card else "cpu",
                     backend=backend, rank=r, world=world, port=store.port)
        recv, send = mp.Pipe(duplex=False)
        proc = mp.Process(target=_peer_main, args=(spec, send),
                          name=f"perfbench-rank-{r}", daemon=True)
        proc.start()
        send.close()
        peers.append(_Peer(rank=r, proc=proc, conn=recv))
    ranks = Ranks(peers, store)
    _OPEN.add(ranks)
    try:
        dist.init_process_group(backend, store=store, rank=0,
                                world_size=world, timeout=timeout)
    except BaseException:
        ranks.__exit__(*sys.exc_info())
        raise
    return ranks


def close_open() -> None:
    """Close every group that a driver's ``run(ctx)`` left open, raising
    as ``Ranks.close()`` does: its peers' checks come before the result."""
    for group in list(_OPEN):
        runner.log("the driver left its ranks open; the harness closes them")
        group.close()
