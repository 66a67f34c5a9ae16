"""The port's public surface against the reference's: every ``__all__``
of the packages both trees hold, with each deliberate difference listed
beside its reason.  A name added on one side only fails here until it is
ported or listed."""
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

PACKAGES = ("core", "api", "engine", "kernels", "serve", "train", "configs",
           "models", "data", "checkpoint")

# (names only the reference exports, names only the port exports)
DIFFERENCES = {
    # the legacy ``use_kernel=`` alias that resolve_engine serves is not
    # ported; the port's collective counter stands in for the reference's
    # HLO check of the mesh executor's all-reduces
    "engine": ({"resolve_engine"},
               {"collective_counter", "record_collective",
                "reset_collective_counter"}),
    # the age-weight ladder the port's streaming and mesh decay share
    "core": (set(), {"decay_ladder"}),
}

# modules without ``__all__``: their public top-level names (functions and
# classes defined there, constants), with the deliberate differences
MODULES = ("launch.perfgate", "launch.roofline", "launch.train")
MODULE_DIFFERENCES = {
    # eager PyTorch has no partitioned HLO text to parse (its role is
    # engine.collective_counter's), and the card's links are NVLink
    "launch.roofline": ({"ICI_BW", "collective_bytes"}, {"NVLINK_BW"}),
    # the parser and a run() that returns the losses, for tests and the
    # smoke script, as launch/serve.py has
    "launch.train": (set(), {"parser", "run"}),
}


def _public(mod) -> set[str]:
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or name == "annotations" or isinstance(
                value, types.ModuleType):
            continue
        if callable(value) and getattr(value, "__module__",
                                       mod.__name__) != mod.__name__:
            continue                                   # imported
        out.add(name)
    return out


@pytest.mark.parametrize("module", MODULES)
def test_module_names_match_the_reference(module):
    ref = _public(importlib.import_module(f"repro.{module}"))
    port = _public(importlib.import_module(f"repro_torch.{module}"))
    only_ref, only_port = MODULE_DIFFERENCES.get(module, (set(), set()))
    assert ref - port == only_ref
    assert port - ref == only_port


@pytest.mark.parametrize("package", PACKAGES)
def test_all_matches_the_reference(package):
    ref = set(importlib.import_module(f"repro.{package}").__all__)
    port = set(importlib.import_module(f"repro_torch.{package}").__all__)
    only_ref, only_port = DIFFERENCES.get(package, (set(), set()))
    assert ref - port == only_ref
    assert port - ref == only_port


@pytest.mark.parametrize("package", PACKAGES)
def test_every_exported_name_resolves(package):
    mod = importlib.import_module(f"repro_torch.{package}")
    assert len(set(mod.__all__)) == len(mod.__all__)
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name


def test_repaired_exports():
    from repro_torch.kernels import compute_moments, ops
    from repro_torch.serve import FleetRequest, fleet
    assert compute_moments is ops.moments
    assert FleetRequest is fleet.FleetRequest


@pytest.mark.parametrize("offsets", [None, [0.0, 0.2, 0.4, 0.45]])
def test_fit_power_law_matches_the_reference(offsets):
    """Degree-1 LSE in log space over the offset grid: the same offset is
    chosen, and a, b, Σe² agree within 1e-4 (float32 logs through a
    normalized 2×2 solve)."""
    from repro.core import fit_power_law as rfit
    from repro_torch.core import PowerLaw, fit_power_law
    r = np.random.default_rng(0)
    x = np.exp(r.uniform(0.0, 8.0, 400)).astype(np.float32)
    y = (3.0 * x ** -0.3 + 0.5 + r.normal(0, 0.005, 400)).astype(np.float32)
    want = rfit(jnp.asarray(x), jnp.asarray(y), offsets=None
                if offsets is None else jnp.asarray(offsets, jnp.float32))
    got = fit_power_law(x, y, offsets=offsets, device="cpu")
    assert isinstance(got, PowerLaw)
    # the same grid point (the two linspaces may round it an ulp apart)
    np.testing.assert_allclose(float(got.offset), float(want.offset),
                               rtol=1e-6)
    for f in ("scale", "exponent", "sse_log"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-4)
    grid = torch.tensor([1.0, 10.0, 1000.0])
    np.testing.assert_allclose(got(grid).numpy(),
                               np.asarray(want(jnp.asarray(grid.numpy()))),
                               rtol=1e-4)
