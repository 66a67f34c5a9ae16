"""fit.solve_idle_ms.batch: the part of ``fit.idle_ms.batch`` that falls
under the program's ``fit.solve`` spans (``core/fit.py``,
``fit_from_moments``): ms per call with the card idle while the host
solved."""
from pbench import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, program_spans.SOLVE)
