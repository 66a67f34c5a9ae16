"""The benchmark's own library: cell lookup, the traffic generator, the
profiler reading, the roofline table and the result line.

Nothing here imports ``jax`` or the JAX package; the port (``repro_torch``)
is imported only by the system drivers under ``perfbench/systems/``.
"""
