"""Companion terminal vocabulary for the protocol fixtures — the same
shape as ``repro_torch.obs.trace``, resolved by the RL-PROTOCOL checker's
sibling-file fallback."""

TERMINAL = ("respond", "failed")
