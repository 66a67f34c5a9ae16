"""The port's sharding rules against the reference's (the sharding half of
``tests/test_sharding_roofline.py``).

* The reference test's spec cases, as cases of one test, on both
  packages.
* For every configuration in ``configs/``, on meshes 16×16, 2×16×16,
  (4, 1), (2, 2) and (1, 4) and under the base, decode and long-context
  rules: every parameter leaf (``param_specs()``), every decode-state
  leaf (``decode_state_specs()``, at decode_32k and long_500k) and every
  batch leaf (``input_specs``) gets the reference's spec.  The reference
  side runs on its test's ``FakeMesh`` (no devices); the port maps the
  reference-layout spec tree onto its modules through ``tree_shardings``,
  and the mapping reaches every reference leaf with the reference's shape
  less the stacking axes.
* On a (2, 2) gloo mesh (4 ranks in subprocesses), each rank's
  ``distribute_tensor`` block equals the block that JAX's
  ``NamedSharding.devices_indices_map`` gives the device at that mesh
  position, on 4 host devices (a reference subprocess).
"""
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro.configs.base import SHAPES as RSHAPES
from repro.models import get_model as rget_model
from repro.sharding import rules as rrules
from repro_torch import configs as tconfigs
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import get_model as tget_model
from repro_torch.sharding import rules as trules

ROOT = Path(__file__).resolve().parent.parent
HELPER = ROOT / "tests" / "_torch_sharded_ranks.py"
_spec = importlib.util.spec_from_file_location("_torch_sharded_ranks", HELPER)
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
CHILD_TIMEOUT = 400


class FakeMesh:
    """The reference test's mesh stand-in: axis names + sizes."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


class PortMesh:
    """The port's mesh stand-in: what ``spec_for`` reads of a DeviceMesh."""

    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x1": {"data": 4, "model": 1},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}}
RULESETS = {"base": None, "decode": rrules.DECODE_OVERRIDES,
            "long": rrules.LONG_CONTEXT_OVERRIDES}
M = {"pod": 2, "data": 16, "model": 16}


def _rules(overrides):
    r = dict(rrules.BASE_RULES)
    r.update(overrides or {})
    return r


# the reference test's spec cases: (mesh, logical, rule set, dims, want)
SPEC_CASES = {
    "basic-pod": (M, ("embed", "q_heads", "head_dim"), None, None,
                  P(("pod", "data"), "model", None)),
    "basic-16x16": ({"data": 16, "model": 16},
                    ("embed", "q_heads", "head_dim"), None, None,
                    P("data", "model", None)),
    "dedupe": (M, ("embed", "embed"), None, None, P(("pod", "data"), None)),
    "divisibility": (M, ("batch", "kv_seq", "kv_heads", "head_dim"), None,
                     (128, 32768, 4, 128), P(("pod", "data"), None, None,
                                             None)),
    "batch-all-data-axes": (M, ("batch", None, "vocab"), None, None,
                            P(("pod", "data"), None, "model")),
    "decode-cache": (M, ("batch", "kv_seq", "kv_heads", "head_dim"),
                     "decode", (128, 32768, 16, 128),
                     P(("pod", "data"), None, "model", None)),
    "decode-head-dim-fallback": (
        M, ("batch", "kv_seq", "kv_heads", "head_dim"), "decode",
        (128, 32768, 20, 128), P(("pod", "data"), None, None, "model")),
    "long-context": (M, ("batch", "kv_seq", "kv_heads", "head_dim"), "long",
                     (1, 524288, 32, 224), P(None, ("data", "model"), None,
                                             None)),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_cases_match_the_reference(case):
    mesh, logical, ruleset, dims, want = SPEC_CASES[case]
    r = _rules(RULESETS[ruleset] if ruleset else None)
    ref = rrules.spec_for(FakeMesh(mesh), logical, r, dims=dims)
    port = trules.spec_for(PortMesh(mesh), logical, r, dims=dims)
    assert ref == want
    assert port == tuple(want)


def _is_spec(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _ref_leaves(spec_tree, shape_tree):
    """{reference path: (logical axes, shape)} of a spec tree and its
    matching ShapeDtypeStruct tree."""
    out = {}

    def walk(spec, shape, path):
        if _is_spec(spec):
            out[path] = (spec, tuple(shape.shape))
        elif isinstance(spec, dict):
            for k in spec:
                walk(spec[k], shape[k], path + (k,))
        else:
            for i, (s, sh) in enumerate(zip(spec, shape)):
                walk(s, sh, path + (i,))
    walk(spec_tree, shape_tree, ())
    return out


def _ref_path(spec_tree, name):
    """The reference path of the port's parameter ``name`` and the number
    of stacking axes the port's tensor lacks (``interop.model_params``'s
    layout: a numeric part indexes a module list, a tuple of layer groups
    at ``i % g``, a stacked subtree along its next leading axis)."""
    node, path, lead = spec_tree, (), 0
    for part in name.split("."):
        if part.isdigit():
            if isinstance(node, tuple) and not _is_spec(node):
                i = int(part) % len(node)
                node, path = node[i], path + (i,)
            lead += 1
        else:
            node, path = node[part], path + (part,)
    return path, lead


def _ref_spec(mesh, logical, shape, overrides):
    return tuple(rrules.spec_for(FakeMesh(mesh), logical,
                                 _rules(overrides), dims=shape))


ARCHS = list(tconfigs.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_specs_match_the_reference(arch):
    rmodel = rget_model(rconfigs.get_config(arch))
    tmodel = tget_model(tconfigs.get_config(arch))
    rspecs = rmodel.param_specs()
    ref = _ref_leaves(rspecs, rmodel.abstract_params())
    params = tmodel.abstract_params()
    reached = set()
    for mname, mesh in MESHES.items():
        for rname, over in RULESETS.items():
            got = trules.tree_shardings(PortMesh(mesh), tmodel.param_specs(),
                                        params, overrides=over)
            for n, p in params.named_parameters():
                path, lead = _ref_path(rspecs, n)
                logical, shape = ref[path]
                assert tuple(p.shape) == shape[lead:], (n, shape)
                want = _ref_spec(mesh, logical, shape, over)
                assert all(e is None for e in want[:lead]), (n, want)
                assert got[n].spec == want[lead:], (mname, rname, n)
                reached.add(path)
    assert reached == set(ref), set(ref) - reached


# (batch, cache length) of the decode cells the rules serve
DECODE_SHAPES = [(RSHAPES[n].global_batch, RSHAPES[n].seq_len)
                 for n in ("decode_32k", "long_500k")]


def _port_state_leaves(shardings, state, path=()):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_port_state_leaves(shardings[k], v, path + (k,)))
        elif shardings[k] is not None:
            out[path + (k,)] = (shardings[k].spec, tuple(v.shape))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_and_batch_specs_match_the_reference(arch):
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    rmodel, tmodel = rget_model(rcfg), tget_model(tcfg)
    rspecs, tspecs = rmodel.decode_state_specs(), tmodel.decode_state_specs()
    for b, length in DECODE_SHAPES:
        if rcfg.family == "audio":
            rstate = jax.eval_shape(
                lambda: rmodel.init_decode_state(b, 256, length))
            tstate = tmodel.init_decode_state(b, 256, length, device="meta")
        else:
            rstate = jax.eval_shape(
                lambda: rmodel.init_decode_state(b, length))
            tstate = tmodel.init_decode_state(b, length, device="meta")
        ref = _ref_leaves(rspecs, rstate)
        for mname, mesh in MESHES.items():
            for rname, over in RULESETS.items():
                got = _port_state_leaves(trules.tree_shardings(
                    PortMesh(mesh), tspecs, tstate, overrides=over), tstate)
                if tcfg.family in ("dense", "moe", "vlm"):
                    # the reference groups its cache: compare each port
                    # leaf (n_layers, ...) with group 0's (n_groups, ...)
                    ref_by = {(k,): ref[("layers", 0, k)] for k in ("k", "v")}
                else:       # ``len`` is a host int in the port
                    ref_by = {k: v for k, v in ref.items() if k != ("len",)}
                assert set(got) == set(ref_by), (set(got), set(ref_by))
                for path, (spec, shape) in got.items():
                    logical, rshape = ref_by[path]
                    assert shape[1:] == rshape[1:], (path, shape, rshape)
                    want = _ref_spec(mesh, logical, rshape, over)
                    assert spec == want, (mname, rname, path, spec, want)
    for sname in [s.name for s in rconfigs.shapes_for(rcfg)]:
        rin = rmodel.input_specs(RSHAPES[sname])
        tin = tmodel.input_specs(TSHAPES[sname])
        leaves = {k: v for k, v in tin.items() if k != "state"}
        assert set(leaves) == {k for k in rin if k != "state"}
        for mname, mesh in MESHES.items():
            for rname, over in RULESETS.items():
                for k, t in leaves.items():
                    logical = ("batch",) + (None,) * (t.ndim - 1)
                    assert tuple(t.shape) == tuple(rin[k].shape), k
                    want = _ref_spec(mesh, logical, tuple(rin[k].shape),
                                     over)
                    got = trules.spec_for(PortMesh(mesh), logical,
                                          _rules(over), dims=tuple(t.shape))
                    assert got == want, (mname, rname, sname, k)


def test_placements_split_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard
    mesh = PortMesh({"pod": 2, "data": 16, "model": 16})
    assert trules.placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert trules.placements(mesh, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        trules.placements(mesh, (("data", "pod"), None))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_distribute_tensor_blocks_match_jax_device_blocks():
    with tempfile.TemporaryDirectory() as d:
        renv = _env()
        renv.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                    JAX_PLATFORMS="cpu")
        procs = [subprocess.Popen(
            [sys.executable, str(HELPER), "indices", f"{d}/idx.json"],
            env=renv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
        procs += [subprocess.Popen(
            [sys.executable, str(HELPER), "rank", "placements", str(r),
             str(R.WORLD), f"{d}/store", f"{d}/blocks.npz"],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(R.WORLD)]
        try:
            for p in procs:
                out = p.communicate(timeout=CHILD_TIMEOUT)[0]
                assert p.returncode == 0, out.decode()[-4000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        with open(f"{d}/idx.json") as f:
            idx = json.load(f)
        blocks = dict(np.load(f"{d}/blocks.npz"))
    for i, (shape, spec) in enumerate(R.PLACEMENT_CASES):
        full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        for r in range(R.WORLD):
            sl = tuple(slice(a, b) for a, b in idx[str(i)][str(r)])
            np.testing.assert_array_equal(blocks[f"{i}/{r}"], full[sl],
                                          err_msg=f"{spec} rank {r}")
