"""Known-bad corpus for RL-PROTOCOL (port; opts into the serve/fleet.py
scope via its name): orphan message, silent-drop dispatch, unacked
ingest, non-terminal trace on a terminated request."""
import dataclasses


@dataclasses.dataclass
class Ingest:
    key: int
    seq: int
    kind: str = "ingest"


@dataclasses.dataclass
class Ack:
    key: int
    seq: int
    kind: str = "ack"


@dataclasses.dataclass
class Probe:
    key: int
    kind: str = "probe"


class Worker:
    def __init__(self):
        self.applied = {}

    def process(self, msg, tick):
        # closed-world violation: no ProtocolError on fallthrough
        if msg.kind == "ingest":
            applied = self.applied.get(msg.key, 0)
            if msg.seq != applied + 1:
                return []          # duplicate delivered but never acked
            self.applied[msg.key] = msg.seq
            return [Ack(msg.key, msg.seq)]
        return []


class Fleet:
    def __init__(self, tracer):
        self.tracer = tracer

    def ping(self, worker, key):
        worker.process(Probe(key), 0)    # "probe" has no handler anywhere

    def _fail(self, req, tick):
        req.done_tick = tick
        self.tracer.instant(req.uid, "gave-up", tick)   # not a terminal
