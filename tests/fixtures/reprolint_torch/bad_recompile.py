"""Known-bad corpus for RL-RECOMPILE (port): every step-key hazard class."""
import dataclasses

from repro_torch.serve.fit_engine import StepFunction

_CACHE = {}


@dataclasses.dataclass
class SpecLike:
    name: str = "fit"
    knobs: dict = {}            # mutable dataclass default


def scale_step(state, factor):
    return state * factor


step = StepFunction(scale_step)


def make_step():
    def shift(state, by):
        return state + by
    return StepFunction(shift)


class Server:
    def __init__(self):
        self._shift = make_step()

    def serve(self, state, xs):
        state = step(state, float(len(xs)))      # a new key per length
        return self._shift(state, int(xs[0]) + 1)   # a new key per value


def lookup(spec):
    return _CACHE[f"{spec}"]    # f-string cache key


def lookup_by_identity(spec):
    return _CACHE.get((id(spec), "x"))   # id() cache key
