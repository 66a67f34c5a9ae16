"""Trace spans on the fleet's virtual tick clock (a copy of
``repro.obs.trace``: framework-free Python, kept here so the port imports
nothing of the reference package; the fit server's step counter is its
tick).

The fleet never sleeps — time is an injected tick counter — so a trace of
its request lifecycle is *deterministic*: same seed, same chaos schedule,
same byte-identical event log.  That turns tracing from a debugging aid
into an assertable artifact (CI's ``obs-smoke`` job diffs invariants over
it, ``tests/test_obs.py`` diffs whole logs across runs).

Events are append-only records ``{seq, ph, uid, name, tick, args}``:

* ``ph="B"/"E"`` — span begin/end (``queue``, ``ingest``, ``solve``);
  begins are idempotent per (uid, name) and ends without a matching open
  begin are dropped, so retry/hedge re-sends cannot corrupt the chain.
* ``ph="i"`` — instant annotations (``submit``, ``admit``, ``degrade``,
  ``shed``, ``retry``, ``replay``, ``hedge``, ``poisoned``, ``respond``,
  ``failed``, fleet-scope ``worker_death`` / ``revival`` under uid -1).

Exports: JSONL (one sorted-keys JSON object per line — byte-stable) and
the Chrome trace-event view (`chrome://tracing` / Perfetto; one tid per
request uid, 1 tick = 1µs).  ``validate_events`` checks the span-chain
invariants the CI job asserts: every admitted uid reaches a terminal
annotation, every replay/hedge/degrade surfaced on the request object has
a matching annotation, and B/E pairs nest correctly.
"""
from __future__ import annotations

import json

FLEET_UID = -1                       # uid for fleet-scope (non-request) events
TERMINAL = ("respond", "failed")     # terminal instant names


class Tracer:
    """Append-only deterministic event recorder.

    The record path is the serving hot loop's cost, so it appends one
    plain tuple per event and defers the dict view (seq numbers, int
    coercion) to first read — the ``obs_overhead`` bench row holds the
    whole enabled layer to <= 5% of the null path."""

    enabled = True

    def __init__(self):
        self._log: list[tuple] = []          # (ph, uid, name, tick, attrs)
        self._view: list[dict] = []          # materialized dict view
        self._open: set[tuple[int, str]] = set()

    @property
    def events(self) -> list[dict]:
        """The event log as dicts ``{seq, ph, uid, name, tick, args}``
        (materialized incrementally from the raw append log)."""
        log, view = self._log, self._view
        for i in range(len(view), len(log)):
            ph, uid, name, tick, attrs = log[i]
            view.append({"seq": i, "ph": ph, "uid": int(uid),
                         "name": name, "tick": int(tick), "args": attrs})
        return view

    def begin(self, uid: int, name: str, tick: int, **attrs) -> None:
        key = (uid, name)
        if key in self._open:        # re-begin (retry/hedge): keep the span
            return
        self._open.add(key)
        self._log.append(("B", uid, name, tick, attrs))

    def end(self, uid: int, name: str, tick: int, **attrs) -> None:
        key = (uid, name)
        if key not in self._open:    # no open span: drop, never corrupt
            return
        self._open.discard(key)
        self._log.append(("E", uid, name, tick, attrs))

    def instant(self, uid: int, name: str, tick: int, **attrs) -> None:
        self._log.append(("i", uid, name, tick, attrs))

    # ------------------------------------------------------------ queries
    def events_for(self, uid: int) -> list[dict]:
        return [e for e in self.events if e["uid"] == uid]

    def names_for(self, uid: int) -> list[str]:
        return [e["name"] for e in self.events if e["uid"] == uid]

    # ------------------------------------------------------------ exports
    def to_jsonl(self) -> str:
        """One sorted-keys JSON object per line: byte-identical across
        runs with the same seed/chaos schedule."""
        return "".join(json.dumps(e, sort_keys=True) + "\n"
                       for e in self.events)

    def export_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing).
        One thread row per request uid; 1 virtual tick = 1µs."""
        out = []
        for e in self.events:
            ev = {"name": e["name"], "ph": e["ph"], "ts": e["tick"],
                  "pid": 0, "tid": e["uid"], "cat": "fleet",
                  "args": e["args"]}
            if e["ph"] == "i":
                ev["s"] = "t"        # thread-scoped instant
            out.append(ev)
        return {"traceEvents": out,
                "displayTimeUnit": "ms",
                "otherData": {"clock": "virtual ticks (1 tick = 1us)"}}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, sort_keys=True)


class NullTracer:
    """The disabled twin: every record is one empty method call."""

    enabled = False
    events: list = []

    def begin(self, uid, name, tick, **attrs) -> None:
        pass

    def end(self, uid, name, tick, **attrs) -> None:
        pass

    def instant(self, uid, name, tick, **attrs) -> None:
        pass

    def events_for(self, uid) -> list:
        return []

    def names_for(self, uid) -> list:
        return []

    def to_jsonl(self) -> str:
        return ""

    def chrome_trace(self) -> dict:
        return {"traceEvents": []}


NULL_TRACER = NullTracer()


# ------------------------------------------------------------- validation
def parse_jsonl(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def validate_events(events: list[dict]) -> list[str]:
    """Check the span-chain invariants over an event log (a ``Tracer``'s
    ``events`` or a parsed JSONL artifact).  Returns a list of problems —
    empty means the log is well-formed:

    * every admitted uid reaches exactly one terminal annotation
      (``respond`` or ``failed``);
    * every ``replay`` / ``hedge`` / ``retry`` annotation belongs to an
      admitted request;
    * span begins/ends pair up (no dangling E, no unclosed B on a
      terminated request);
    * per-uid ticks are non-decreasing in event order.
    """
    problems: list[str] = []
    by_uid: dict[int, list[dict]] = {}
    for e in events:
        by_uid.setdefault(e["uid"], []).append(e)
    for uid, evs in sorted(by_uid.items()):
        if uid == FLEET_UID:
            continue
        names = [e["name"] for e in evs]
        admitted = "admit" in names
        terminals = [n for n in names if n in TERMINAL]
        if admitted and len(terminals) != 1:
            problems.append(f"uid {uid}: admitted but {len(terminals)} "
                            f"terminal events {terminals}")
        if not admitted and terminals and "shed" not in names:
            problems.append(f"uid {uid}: terminal without admit")
        for n in ("replay", "hedge", "retry"):
            if n in names and not admitted:
                problems.append(f"uid {uid}: {n} on unadmitted request")
        open_spans: set[str] = set()
        last_tick = None
        for e in evs:
            if last_tick is not None and e["tick"] < last_tick:
                problems.append(f"uid {uid}: tick went backwards at "
                                f"seq {e['seq']}")
            last_tick = e["tick"]
            if e["ph"] == "B":
                if e["name"] in open_spans:
                    problems.append(f"uid {uid}: double-begin "
                                    f"{e['name']!r}")
                open_spans.add(e["name"])
            elif e["ph"] == "E":
                if e["name"] not in open_spans:
                    problems.append(f"uid {uid}: end without begin "
                                    f"{e['name']!r}")
                open_spans.discard(e["name"])
        if terminals and open_spans:
            problems.append(f"uid {uid}: terminated with open spans "
                            f"{sorted(open_spans)}")
    return problems


def assert_valid(events: list[dict]) -> None:
    problems = validate_events(events)
    if problems:
        raise AssertionError("trace invariants violated:\n  "
                             + "\n  ".join(problems))
