"""The port's gradient compression against the reference's, on the CPU:
the four tests of ``tests/test_compression.py``, the quantizer bit-equal
to the reference's, and the compressed all-reduce on 8 gloo ranks (one
row of the same (8, 512) gradients each, ``tests/_torch_compression_ranks
.py``) against the reference's ``shard_map`` over 8 host devices in a
subprocess.  Bars: quantize, dequantize and the eager residual bit-equal
(the same elementwise float32 arithmetic, round half to even in both);
under the reference's jit, each rank's residual within one float32
rounding of max|g|; the mean within 1e-6 of max|mean| (8 float32 terms
summed in another order); the reference's own bars against the true
mean."""
import importlib.util
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.train import compression as rcomp
from repro_torch.train import compression as comp

settings.register_profile("torch_comp", deadline=None, max_examples=20)
settings.load_profile("torch_comp")

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).resolve().parent / "_torch_compression_ranks.py"
_spec = importlib.util.spec_from_file_location("_torch_compression_ranks",
                                               HELPER)
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
CHILD_TIMEOUT = 300      # seconds for the reference / each rank process


@given(st.integers(0, 10_000))
def test_quantize_dequantize_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 3, (37, 19)).astype(np.float32))
    q, scale = comp.quantize(x)
    assert q.dtype == torch.int8 and q.shape == (3, comp.BLOCK)
    back = comp.dequantize(q, scale, x.shape)
    # per-block max error <= scale/2 = max|block| / 254
    err = (back - x).abs().numpy()
    bound = x.abs().max().item() / 127.0
    assert err.max() <= bound + 1e-6


@pytest.mark.parametrize("shape", [(37, 19), (256,), (5,), (2, 3, 300)])
def test_quantize_equals_the_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(0, 3, shape).astype(np.float32)
    x.flat[0] = 0.0
    q, scale = comp.quantize(torch.from_numpy(x))
    rq, rscale = rcomp.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    np.testing.assert_array_equal(
        comp.dequantize(q, scale, shape).numpy(),
        np.asarray(rcomp.dequantize(rq, rscale, shape)))
    zeros = comp.quantize(torch.zeros(3))       # an all-zero block
    assert not zeros[0].any() and not zeros[1].any()


def test_error_feedback_unbiased_over_time():
    """With error feedback, the accumulated transmitted signal converges to
    the accumulated true signal (residual stays bounded); every step's
    payload and residual equal the reference's."""
    rng = np.random.default_rng(0)
    true_np = rng.normal(0, 1, (256,)).astype(np.float32)
    true = torch.from_numpy(true_np)
    residual = torch.zeros(256)
    rresidual = jnp.zeros((256,), jnp.float32)
    sent_total = np.zeros(256)
    for _ in range(50):
        (q, s), residual = comp.compress_residual(true, residual)
        (rq, rs), rresidual = rcomp.compress_residual(jnp.asarray(true_np),
                                                      rresidual)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(residual.numpy(),
                                      np.asarray(rresidual))
        sent_total += comp.dequantize(q, s, true.shape).numpy()
    np.testing.assert_allclose(sent_total / 50, true_np, rtol=0.05,
                               atol=0.02)
    assert residual.abs().max().item() < 0.1


def test_wire_bytes_are_4x_smaller():
    """The int8 payload (what crosses the link) is 4x smaller than f32 +
    per-256 scales overhead."""
    x = torch.ones(1024)
    q, scale = comp.quantize(x)
    wire = q.numel() + scale.numel() * 4
    assert wire < x.numel() * 4 / 3.5
    assert comp.init_residuals({"a": x, "b": [x[:3]]})["b"][0].dtype == \
        torch.float32


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_compressed_allreduce_on_8_gloo_ranks_matches_shard_map():
    with tempfile.TemporaryDirectory() as d:
        renv = _env()
        renv.update(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                    JAX_PLATFORMS="cpu")
        procs = [subprocess.Popen(
            [sys.executable, str(HELPER), "reference", f"{d}/ref.npz"],
            env=renv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
        procs += [subprocess.Popen(
            [sys.executable, str(HELPER), "rank", str(r), str(R.WORLD),
             f"{d}/store", f"{d}/rank{r}.npz"],
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
        ref = dict(np.load(f"{d}/ref.npz"))
        ranks = [dict(np.load(f"{d}/rank{r}.npz")) for r in range(R.WORLD)]
    g = R.grads()
    want = ref["mean"][0]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["mean"], ranks[0]["mean"])
        assert np.abs(out["mean"] - want).max() <= \
            1e-6 * np.abs(want).max()
        # jitted, XLA may fuse the residual's q·scale and subtraction into
        # one fused multiply-add (one rounding against the port's two)
        assert np.abs(out["residual"] - ref["residual"][r]).max() <= \
            2.0 ** -23 * np.abs(g[r]).max()
        # one all-reduce, counted with the int8 payload and its scales
        assert int(out["calls"]) == 1
        assert int(out["bytes"]) == 512 + 2 * 4
        # the tree form: each leaf compressed on its own
        np.testing.assert_allclose(out["tree_a"].reshape(-1),
                                   g[:, :300].mean(0), rtol=0.05, atol=0.03)
        np.testing.assert_allclose(out["tree_b"], g[:, 300:].mean(0),
                                   rtol=0.05, atol=0.03)
        assert out["tree_res_a"].shape == (3, 100)
    # the reference test's own bars against the true mean
    np.testing.assert_allclose(ranks[0]["mean"], g.mean(0), rtol=0.05,
                               atol=0.03)
