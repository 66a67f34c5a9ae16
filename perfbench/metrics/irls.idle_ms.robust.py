"""irls.idle_ms.robust: ms per call in which the card ran nothing while
the host was inside the program's ``irls.converge`` spans
(``core/robust.py`` ``still_moving``: the IRLS loop's read of
``any(delta > tol)``, once a sweep, which drains the card's queue).
None where the program records no such span."""
from pbench import program_spans

SPAN = "irls.converge"


def read(ctx):
    if not program_spans.named(program_spans.recorded(), SPAN):
        return None
    return program_spans.idle_ms(ctx, SPAN)
