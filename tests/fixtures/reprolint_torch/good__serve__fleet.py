"""Known-good corpus for RL-PROTOCOL (port): closed vocabulary, typed raises,
acked ingests, terminal parity with the tracer."""
import dataclasses


class ProtocolError(RuntimeError):
    def __init__(self, where, kind):
        self.kind = kind
        super().__init__(f"{where}: unknown message kind {kind!r}")


@dataclasses.dataclass
class Ingest:
    key: int
    seq: int
    kind: str = "ingest"


@dataclasses.dataclass
class Solve:
    key: int
    kind: str = "solve"


@dataclasses.dataclass
class Ack:
    key: int
    seq: int
    kind: str = "ack"


@dataclasses.dataclass
class Result:
    key: int
    kind: str = "result"


class Worker:
    def __init__(self):
        self.applied = {}

    def process(self, msg, tick):
        if msg.kind == "ingest":
            applied = self.applied.get(msg.key, 0)
            if msg.seq != applied + 1:
                return [Ack(msg.key, applied)]   # duplicates still acked
            self.applied[msg.key] = msg.seq
            return [Ack(msg.key, msg.seq)]
        if msg.kind == "solve":
            return [Result(msg.key)]
        raise ProtocolError("worker", msg.kind)


class Fleet:
    def __init__(self, tracer):
        self.tracer = tracer

    def pump(self, worker, key, tick):
        for rep in worker.process(Ingest(key, 1), tick):
            self.handle(rep, tick)
        for rep in worker.process(Solve(key), tick):
            self.handle(rep, tick)

    def handle(self, rep, tick):
        if rep.kind == "ack":
            return
        if rep.kind == "result":
            self.finish(rep, tick)
            return
        raise ProtocolError("dispatcher", rep.kind)

    def finish(self, rep, tick):
        rep.done_tick = tick
        self.tracer.instant(rep.key, "respond", tick)

    def abandon(self, rep, tick):
        rep.done_tick = tick
        self.tracer.instant(rep.key, "failed", tick)
