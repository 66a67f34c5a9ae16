"""fit.host_ms.batch: host ms per call spent inside the program, read
from its outermost phase spans (``api.fit``; ``stream.state``,
``stream.update``, ``stream.result``) in the profiled sub-window."""
from pbench import program_spans


def read(ctx):
    return program_spans.host_ms(ctx)
