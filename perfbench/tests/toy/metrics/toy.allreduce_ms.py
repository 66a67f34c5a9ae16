"""toy.allreduce_ms: host ms per call that rank 0 spends in the
all-reduce of the toy system's sums."""


def read(ctx):
    counts = ctx.get("counts") or {}
    if not counts.get("calls"):
        return None
    return counts["allreduce_s"] * 1e3 / counts["calls"]
