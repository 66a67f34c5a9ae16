"""fit.idle_ms.batch: ms per call in which the card ran nothing while the
host was inside the program's outermost phase spans (``api.fit``;
``stream.state``, ``stream.update``, ``stream.result``), in the profiled
sub-window."""
from pbench import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx)
