"""irls.sweeps.robust: IRLS sweeps per call in the profiled sub-window,
the sum of ``FitResult.iterations`` over its calls ÷ the calls.  Each
sweep is a scale, a weighted moment pass, a solve and a host read."""


def read(ctx):
    counts = ctx.get("counts") or {}
    calls = counts.get("calls")
    if not calls or counts.get("sweeps") is None:
        return None
    return counts["sweeps"] / calls
