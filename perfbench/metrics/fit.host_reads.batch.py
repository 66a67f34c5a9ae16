"""fit.host_reads.batch: device-to-host copies per call that start while
the host is inside the program's outermost phase spans (``api.fit``;
``stream.*``): reads the program makes, each draining the queue."""
from pbench import program_spans


def read(ctx):
    return program_spans.host_reads(ctx)
