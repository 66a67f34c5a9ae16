"""Known-good corpus for RL-RECOMPILE (port): keys from shapes, literals
and specs only."""
import dataclasses

from repro_torch.serve.fit_engine import StepFunction

_CACHE = {}


@dataclasses.dataclass(frozen=True)
class SpecLike:
    name: str = "fit"
    knobs: tuple = ()
    tags: tuple = dataclasses.field(default=())


def scale_step(state, factor, spec):
    return state * factor


step = StepFunction(scale_step)


class Server:
    def __init__(self, spec):
        self.spec = spec

    def serve(self, state, factor):
        # a tensor argument keys by shape and dtype, a literal by one value,
        # a frozen spec by its fields
        state = step(state, factor, self.spec)
        return step(state, 2.0, SpecLike())


def lookup(spec):
    key = (spec.name, spec.knobs)        # tuple of hashable statics
    return _CACHE[key]
