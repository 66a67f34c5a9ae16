"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU the port's wrappers run the kernels' plain versions (a CPU
tensor is the only reason they do); the reference's Pallas kernels run in
interpret mode at tiny shapes (B ∈ {1, 3, 26}, n <= 300, block_n=128).
Tolerance: float32 sums of <= 300 terms in another order, rtol 2e-5 with
atol 1e-3 on entries that cancel (bf16 inputs: rtol 1e-4, atol 5e-2).
The CUDA kernels themselves are tested on the card by
``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import moments as K
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

FIELDS = ("gram", "vty", "yty", "count", "weight_sum")


def _data(seed, shape, zero_weights=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, shape).astype(np.float32)
    y = rng.normal(0, 1, shape).astype(np.float32)
    w = None
    if zero_weights:
        w = (rng.uniform(0.2, 2.0, shape)
             * (rng.uniform(size=shape) > 0.3)).astype(np.float32)
    return x, y, w


def _close(tm, jm, rtol=2e-5, atol=1e-3):
    for f in FIELDS:
        got = getattr(tm, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(getattr(jm, f), np.float64),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("b,n,degree,packing,weighted,compensated", [
    (1, 300, 3, "plain", False, False),
    (1, 6, 0, "auto", False, True),
    (3, 257, 7, "plain", True, False),
    (3, 200, 7, "packed", False, True),
    (26, 150, 3, "auto", True, False),      # 25 per tile + a tail series
    (3, 130, 20, "auto", False, False),
])
def test_moments_against_pallas(b, n, degree, packing, weighted,
                                compensated):
    x, y, w = _data(b * n + degree, (b, n), weighted)
    jm = jops.moments(jnp.asarray(x), jnp.asarray(y), degree,
                      weights=None if w is None else jnp.asarray(w),
                      block_n=128, packing=packing, compensated=compensated,
                      interpret=True)
    tm = ops.moments(x, y, degree, weights=w, packing=packing,
                     compensated=compensated, device="cpu")
    _close(tm, jm)
    if weighted:   # true count, not Σw
        np.testing.assert_array_equal(tm.count.numpy(), (w != 0).sum(-1))


def test_moments_bf16_and_flat_input():
    x, y, _ = _data(5, (2, 140))
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    jm = jops.moments(xb, yb, 3, block_n=128, interpret=True)
    tm = ops.moments(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(y).bfloat16(), 3, device="cpu")
    _close(tm, jm, rtol=1e-4, atol=5e-2)
    jf = jops.moments(jnp.asarray(x[0]), jnp.asarray(y[0]), 3, block_n=128,
                      interpret=True)
    tf = ops.moments(x[0], y[0], 3, device="cpu")
    assert tf.gram.shape == (4, 4) and tf.yty.ndim == 0
    _close(tf, jf)


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_report_sums_against_pallas(weighted):
    x, y, w = _data(6, (3, 300), weighted)
    c = np.random.default_rng(7).normal(size=(3, 4)).astype(np.float32)
    js = jops.fused_report_sums(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(c),
                                weights=None if w is None else jnp.asarray(w),
                                block_n=128, interpret=True)
    ts = ops.fused_report_sums(x, y, c, weights=w, device="cpu")
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].double().numpy(),
                                   np.asarray(js[k], np.float64), rtol=2e-5,
                                   atol=1e-3, err_msg=k)
    flat = ops.fused_report_sums(x[0], y[0], c[0], device="cpu")
    assert flat["sse"].ndim == 0


def test_plain_versions_equal_the_reference_oracle_blocks():
    x, y, w = _data(8, (3, 90), True)
    tx, ty, tw = map(torch.from_numpy, (x, y, w))
    g = K.moments_block_plain(tx, ty, tw, 5)
    full = ref.extended_gram(tx, ty, 5, tw)
    np.testing.assert_allclose(g.numpy(), full[:, :7, :7].numpy(),
                               rtol=1e-5, atol=1e-4)
    assert float(full[:, 7:, :].abs().max()) == 0.0   # padding rows zero


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    K.reset_launch_counts()
    x, y, _ = _data(9, (2, 50))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    K.moments_plain(tx, ty, degree=2)
    K.moments_packed(tx, ty, degree=2)
    K.moments_packed_ring(tx, ty, degree=2, block_n=32, nbuf=2)
    K.fused_report(tx, ty, None, torch.zeros(2, 3))
    assert K.launch_counts() == {"moments_plain": 0, "moments_packed": 0,
                                 "moments_packed_ring": 0,
                                 "fused_report": 0, "solve_small": 0}


def test_nbuf_and_packing_validation():
    x, y, _ = _data(10, (2, 20))
    m0 = ops.moments(x, y, 3, device="cpu")
    m2 = ops.moments(x, y, 3, nbuf=2, device="cpu")
    m3 = ops.moments(x, y, 3, nbuf=3, block_n=64, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(m0, f), getattr(m2, f)), f
        assert torch.equal(getattr(m0, f), getattr(m3, f)), f
    with pytest.raises(ValueError):
        ops.moments(x, y, 3, nbuf=1, device="cpu")
    with pytest.raises(ValueError):
        ops.moments(x, y, 3, nbuf=-2, device="cpu")
    with pytest.raises(ValueError, match="plain"):
        ops.moments(x, y, 3, nbuf=2, packing="plain", device="cpu")
    with pytest.raises(ValueError, match="plain"):
        ops.moments(x[0], y[0], 3, nbuf=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.moments(x, y, 3, nbuf=2, block_n=100, device="cpu")
    with pytest.raises(ValueError):
        ops.moments(x, y, 3, packing="tiled", device="cpu")
    with pytest.raises(ValueError):
        ops.moments(x, y, 70, packing="packed", device="cpu")
    with pytest.raises(ValueError):
        ops.fused_report_sums(x, y, np.zeros((2, 129), np.float32),
                              device="cpu")


def test_build_command_targets_sm90a_without_fast_math(tmp_path):
    srcs = build.sources()
    assert [s.name for s in srcs] == ["moments.cu", "moments_ring.cu",
                                      "solve.cu"]
    objs = [tmp_path / f"{s.stem}.o" for s in srcs]
    for src, obj in zip(srcs, objs):
        cmd = build.compile_command(src, obj, "nvcc")
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined
        assert "-O3" in cmd and "-c" in cmd and cmd[-1] == str(src)
        assert "fast_math" not in joined and "fast-math" not in joined
    link = build.link_command(objs, tmp_path / "lib.so", "nvcc")
    assert "-shared" in link and link[-len(objs):] == [str(o) for o in objs]
    assert "fast_math" not in " ".join(link)
    assert [h.name for h in build.headers()] == ["moments_common.cuh"]
    assert build.library_path().parent == build.BUILD_DIR
    assert build.library_path().name.startswith("librepro_kernels_")


@pytest.mark.parametrize("b,n,tasks_per_cta", [
    (1, 1 << 28, 1), (4096, 1 << 16, 8), (2, 1 << 28, 8), (64, 77, 1),
    (3, 5000, 1)])
def test_splits_fill_the_card_and_stay_deterministic(b, n, tasks_per_cta):
    s = K.splits(b, n, tasks_per_cta, 132)
    assert s == K.splits(b, n, tasks_per_cta, 132)
    assert 1 <= s <= max(1, -(-n // K.MIN_SPLIT_POINTS))
    if n >= K.MIN_SPLIT_POINTS * 1056:
        assert b * s >= K.CTAS_PER_SM * 132 * tasks_per_cta


def test_kernel_plan_takes_multi_axis_batches():
    """A kernel plan on a (3, 4, n) batch flattens the leading axes for
    the kernel and restores them on every field (the fold pass of degree
    selection hands the kernel (k, ..., n/k)).  Held against the
    reference's jnp moments on the same inputs; rtol 2e-5, atol 1e-3 as
    above."""
    from repro import core as jcore
    from repro_torch import engine
    x, y, w = _data(12, (3, 4, 90), zero_weights=True)
    jm = jcore.gram_moments(jnp.asarray(x), jnp.asarray(y), 3,
                            weights=jnp.asarray(w))
    for path in ("kernel_packed", "kernel_plain"):
        plan = engine.plan_fit(x.shape, 3, engine=path, device="cpu")
        tm = engine.compute_moments(plan, torch.from_numpy(x),
                                    torch.from_numpy(y), torch.from_numpy(w))
        assert tm.gram.shape == (3, 4, 4, 4) and tm.count.shape == (3, 4)
        _close(tm, jm)
    tm = ops.moments(x, y, 3, weights=w[0], packing="packed", nbuf=2,
                     block_n=32, device="cpu")
    assert tm.weight_sum.shape == (3, 4)
    np.testing.assert_allclose(tm.weight_sum.numpy(),
                               np.broadcast_to(w[0].sum(-1), (3, 4)),
                               rtol=1e-6)


# ------------------------------------------------------------ the domain map
def _domains(kind, x):
    from repro_torch.core import basis
    if kind == "identity":
        return basis.Domain.identity(x.dtype)
    return basis.Domain.from_data(x * 1.7 + 0.3)        # scale != 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["identity", "normalized"])
def test_domain_handed_down_keeps_the_two_step_bits(kind, dtype):
    """``compute_moments(..., domain=)`` on raw x, on every path, and
    ``ops.moments(..., domain=)`` on every layout, are bit-equal to the
    same call on ``Domain.apply(x)``."""
    from repro_torch import engine
    x, y, w = (torch.from_numpy(a).to(dtype)
               for a in _data(13, (5, 203), zero_weights=True))
    dom = _domains(kind, x)
    xd = dom.apply(x)
    assert (kind == "identity") == torch.equal(xd, x)
    for path in ("reference", "kernel_packed", "kernel_plain"):
        plan = engine.plan_fit(tuple(x.shape), 3, engine=path, dtype=dtype,
                               device="cpu")
        for wc in (None, w):
            got = engine.compute_moments(plan, x, y, wc, domain=dom)
            want = engine.compute_moments(plan, xd, y, wc)
            for f in FIELDS:
                assert torch.equal(getattr(got, f), getattr(want, f)), \
                    (path, f)
    for kw in ({"packing": "plain"}, {"packing": "packed"},
               {"nbuf": 2, "block_n": 64}):
        got = ops.moments(x, y, 3, weights=w, domain=dom, device="cpu", **kw)
        want = ops.moments(xd, y, 3, weights=w, device="cpu", **kw)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (kw, f)


def _no_library():
    raise AssertionError("the kernel library was asked for")


@pytest.mark.parametrize("launcher", ["plain", "packed", "ring"])
@pytest.mark.parametrize("case,err,match", [
    ("shift_only", ValueError, "both shift and scale"),
    ("scale_only", ValueError, "both shift and scale"),
    ("dtype", TypeError, "dtype"),
    ("not_0d", ValueError, "0-d"),
    ("device", ValueError, "device"),
])
def test_launchers_refuse_a_bad_map_before_any_launch(monkeypatch, launcher,
                                                      case, err, match):
    monkeypatch.setattr(build, "library", _no_library)
    monkeypatch.setattr(K, "moments_block_plain", _no_library)
    x, y = (torch.from_numpy(a) for a in _data(14, (2, 40))[:2])
    shift, scale = torch.tensor(0.5), torch.tensor(2.0)
    if case == "shift_only":
        scale = None
    elif case == "scale_only":
        shift = None
    elif case == "dtype":
        scale = scale.double()
    elif case == "not_0d":
        shift = shift.reshape(1)
    else:
        shift = torch.empty((), device="meta")
    fn = {"plain": K.moments_plain, "packed": K.moments_packed,
          "ring": lambda *a, **k: K.moments_packed_ring(
              *a, block_n=32, nbuf=2, **k)}[launcher]
    with pytest.raises(err, match=match):
        fn(x, y, None, degree=3, shift=shift, scale=scale)


class _StubLibrary:
    """Stands in for the kernel library: records each moment call."""

    def __init__(self):
        self.calls = []

    def repro_moments(self, *args):
        self.calls.append(("repro_moments", args))
        return 0

    def repro_moments_ring(self, *args):
        self.calls.append(("repro_moments_ring", args))
        return 0


def test_mapped_launches_count_and_reset(monkeypatch):
    """Every launch hands the kernel two map pointers, last: the caller's
    shift and scale, or else the identity's 0 and 1 in x's dtype on x's
    device, the same tensors on a second launch.  Each launch counts once
    under its launcher; ``reset_launch_counts()`` clears the counts."""
    import contextlib
    import types
    lib = _StubLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(K, "_check_inputs", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    x, y, _ = _data(15, (2, 64))
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    shift, scale = torch.tensor(0.25), torch.tensor(4.0)
    K.reset_launch_counts()
    K._launch_moments(0, "moments_plain", x, y, None, 3, torch.float32,
                      False, shift=shift, scale=scale)
    K._launch_moments(1, "moments_packed", x, y, None, 3, torch.float32,
                      False)
    K._launch_moments(1, "moments_packed_ring", x, y, None, 3,
                      torch.float32, True, ring=(32, 2))
    K._launch_moments(1, "moments_packed", x.double(), y.double(), None, 3,
                      torch.float64, False)
    assert K.launch_counts() == {"moments_plain": 1, "moments_packed": 2,
                                 "moments_packed_ring": 1,
                                 "fused_report": 0, "solve_small": 0}
    names = [name for name, _ in lib.calls]
    assert names == ["repro_moments"] * 2 + ["repro_moments_ring",
                                             "repro_moments"]
    ident = K._identity_map(x)
    ident64 = K._identity_map(x.double())
    for t, dtype, v in zip(ident + ident64, [torch.float32] * 2
                           + [torch.float64] * 2, [0.0, 1.0] * 2):
        assert (t.ndim, t.dtype, t.device, float(t)) == (0, dtype, x.device,
                                                         v)
    tails = [args[-3:] for _, args in lib.calls]
    assert tails[0] == (7, shift.data_ptr(), scale.data_ptr())
    assert tails[1] == tails[2] == (7, ident[0].data_ptr(),
                                    ident[1].data_ptr())
    assert tails[3] == (7, ident64[0].data_ptr(), ident64[1].data_ptr())
    assert all(None not in tail for tail in tails)
    K.reset_launch_counts()
    assert sum(K.launch_counts().values()) == 0


@pytest.mark.parametrize("case", ["domain_float64", "domain_shaped",
                                  "x_float16", "x_y_dtypes"])
def test_ops_maps_first_where_the_kernel_cannot(monkeypatch, case):
    """Where x would reach the kernel converted, or the domain's scalars
    are not 0-d in x's dtype, ``ops.moments`` maps x first and hands the
    launcher no map: the bits of the two-step path all the same."""
    from repro_torch.core import basis
    seen = []
    real = K.moments_packed

    def spy(*args, **kw):
        seen.append((kw["shift"], kw["scale"]))
        return real(*args, **kw)

    monkeypatch.setattr(K, "moments_packed", spy)
    x, y = (torch.from_numpy(a) for a in _data(16, (3, 50))[:2])
    dom = basis.Domain.from_data(x)
    if case == "domain_float64":
        dom = basis.Domain(dom.shift.double(), dom.scale.double())
    elif case == "domain_shaped":
        dom = basis.Domain(dom.shift.reshape(1), dom.scale.reshape(1))
    elif case == "x_float16":
        x = x.half()
        dom = basis.Domain(dom.shift.half(), dom.scale.half())
    else:
        y = y.double()
    got = ops.moments(x, y, 3, domain=dom, packing="packed", device="cpu")
    want = ops.moments(dom.apply(x), y, 3, packing="packed", device="cpu")
    assert seen == [(None, None), (None, None)]
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # the same call with a 0-d domain of x's dtype hands the map down
    if case == "domain_float64":
        seen.clear()
        dom32 = basis.Domain.from_data(x)
        ops.moments(x, y, 3, domain=dom32, packing="packed", device="cpu")
        assert seen == [(dom32.shift, dom32.scale)]


def test_identity_map_is_made_once_across_threads(monkeypatch):
    """Fleet workers launch from threads: however many ask at once, one
    (shift, scale) pair is made for a (dtype, device) and every caller
    gets that pair (20 rounds, each from an empty cache)."""
    import sys
    import threading
    made = []
    real = torch.tensor

    def counting(*a, **kw):
        made.append(kw.get("dtype"))
        return real(*a, **kw)

    monkeypatch.setattr(torch, "tensor", counting)
    xs = [torch.zeros(3, dtype=d) for d in (torch.float32, torch.float64)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            monkeypatch.setattr(K, "_IDENTITY", {})
            made.clear()
            got = [[] for _ in range(16)]
            start = threading.Barrier(len(got))

            def work(i):
                start.wait(timeout=30)
                for _ in range(5):
                    got[i].append(K._identity_map(xs[i % 2]))

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(len(got))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert sorted(made, key=str) == sorted(
                [torch.float32] * 2 + [torch.float64] * 2, key=str)
            for i, pairs in enumerate(got):
                want = K._IDENTITY[(xs[i % 2].dtype, xs[i % 2].device)]
                assert len(pairs) == 5 and all(p is want for p in pairs)
    finally:
        sys.setswitchinterval(old)
