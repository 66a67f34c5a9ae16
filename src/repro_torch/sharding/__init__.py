"""Sharding rules as DTensor placements (port of ``repro.sharding``).

``constrain`` (the models' activation constraint) lives in ``rules`` as in
the reference; the port adds ``NamedSharding`` (a spec on a mesh) and
``placements`` (a spec as DTensor placements)."""
from repro_torch.sharding.rules import (BASE_RULES, LONG_CONTEXT_OVERRIDES,
                                        DECODE_OVERRIDES, NamedSharding,
                                        spec_for, placements, tree_shardings,
                                        data_axes, batch_sharding,
                                        replicated)

__all__ = ["BASE_RULES", "LONG_CONTEXT_OVERRIDES", "DECODE_OVERRIDES",
           "NamedSharding", "spec_for", "placements", "tree_shardings",
           "data_axes", "batch_sharding", "replicated"]
