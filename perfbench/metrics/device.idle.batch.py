"""device.idle.batch: percent of the profiled window with nothing on the
card."""
from pbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
