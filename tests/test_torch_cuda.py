"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card (a
CUDA kernel has no CPU mode).  The file imports neither jax nor the
reference package, so it runs on a machine that has only the port:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: max|Δ| <= 1e-5 · max|ref| per series, against the plain
version accumulated in float64 (float32 sums over ~5000 points)."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import moments as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3, 7, 14, 20, 126])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("compensated", [False, True])
def test_cuda_moment_kernels_match_plain(cuda, degree, dtype, compensated):
    g = torch.Generator(device=cuda).manual_seed(degree)
    b, n = 11, 5003
    x = (torch.rand(b, n, generator=g, device=cuda) * 2 - 1).to(dtype)
    y = torch.randn(b, n, generator=g, device=cuda).to(dtype)
    w = torch.rand(b, n, generator=g, device=cuda) * (
        torch.rand(b, n, generator=g, device=cuda) > 0.3)
    for wc in (None, w):
        want = K.moments_block_plain(x, y, wc, degree, torch.float64)
        for fn in (K.moments_plain, K.moments_packed):
            got = fn(x, y, wc, degree=degree, compensated=compensated)
            torch.cuda.synchronize()
            err = (got.double() - want).abs().amax((1, 2))
            assert bool((err <= 1e-5 * want.abs().amax((1, 2))).all())
            again = fn(x, y, wc, degree=degree, compensated=compensated)
            assert torch.equal(got, again)          # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3, 9, 127])
def test_cuda_report_kernel_matches_plain(cuda, degree):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(5, 7001, generator=g, device=cuda) * 2 - 1
    y = torch.randn(5, 7001, generator=g, device=cuda)
    c = torch.randn(5, degree + 1, generator=g, device=cuda) / (degree + 1)
    got = K.fused_report(x, y, None, c)
    want = K.fused_report_plain(x, y, None, c, torch.float64)
    err = (got.double() - want).abs().amax(0)
    assert bool((err <= 1e-5 * want.abs().amax(0)).all())


@pytest.mark.cuda
def test_cuda_launch_counts_and_fit(cuda):
    from repro_torch import api, core
    K.reset_launch_counts()
    x = torch.rand(4, 40000, device=cuda) * 2 - 1
    y = 1 + x - x ** 3
    res = api.fit(x, y, api.FitSpec(degree=3))
    core.fit_report_streamed(res.poly, x, y)
    api.fit(x[0], y[0], api.FitSpec(degree=3))
    assert K.launch_counts() == {"moments_plain": 1, "moments_packed": 1,
                                 "moments_packed_ring": 0,
                                 "fused_report": 1}
    np.testing.assert_allclose(res.coeffs.cpu().numpy(),
                               np.tile([1.0, 1.0, 0.0, -1.0], (4, 1)),
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3, 7, 14, 20, 62])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("compensated", [False, True])
def test_cuda_ring_kernel_bit_equals_packed(cuda, degree, dtype,
                                            compensated):
    """The ring changes only the loads: same bits as moments_packed for
    every block and nbuf, weighted or not, on ragged lengths and on views
    that start at an odd element (a bfloat16 row off its 4-byte word)."""
    g = torch.Generator(device=cuda).manual_seed(degree + 7)
    b, n = 11, 5003
    x = (torch.rand(b, n + 1, generator=g, device=cuda) * 2 - 1).to(dtype)
    y = torch.randn(b, n + 1, generator=g, device=cuda).to(dtype)
    w = torch.rand(b, n, generator=g, device=cuda) * (
        torch.rand(b, n, generator=g, device=cuda) > 0.3)
    for xc, yc in ((x[:, :n].contiguous(), y[:, :n].contiguous()),
                   (x.flatten()[1:1 + b * n].view(b, n),
                    y.flatten()[1:1 + b * n].view(b, n))):
        for wc in (None, w):
            want = K.moments_packed(xc, yc, wc, degree=degree,
                                    compensated=compensated)
            for block_n, nbuf in ((32, 2), (128, 3), (256, 4), (512, 2)):
                got = K.moments_packed_ring(xc, yc, wc, degree=degree,
                                            block_n=block_n, nbuf=nbuf,
                                            compensated=compensated)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (block_n, nbuf)


@pytest.mark.cuda
def test_cuda_ring_smem_path_with_static_and_dynamic_past_48k(cuda):
    """Degree 20: a 37 KB ring beside the 16 KB static tile needs the
    opt-in for more than 48 KB in all, though the ring alone is below."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand(5, 9000, generator=g, device=cuda) * 2 - 1
    y = torch.randn(5, 9000, generator=g, device=cuda)
    w = torch.rand(5, 9000, generator=g, device=cuda)
    want = K.moments_packed(x, y, w, degree=20)
    got = K.moments_packed_ring(x, y, w, degree=20, block_n=1024, nbuf=3)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3, 7, 14, 15, 20, 62])
def test_cuda_budget_model_matches_the_launcher(cuda, degree):
    """tune.ring_smem_bytes is the planning copy of the launcher's
    ring_cta_bytes: same bytes for every dtype pair, block, nbuf and
    weighting; and the card's opt-in limit is the planning budget."""
    from repro_torch.kernels import build, tune
    lib = build.library()
    for (din, dacc), bn, nbuf, wt in itertools.product(
            ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.float64, torch.float64), (torch.float32, torch.float64)),
            tune.CANDIDATE_BLOCKS, (2, 3, 4), (False, True)):
        want = lib.repro_ring_smem_bytes(K._IN_CODES[din], K._ACC_CODES[dacc],
                                         degree, bn, nbuf, int(wt))
        got = tune.ring_smem_bytes(degree, bn, nbuf=nbuf,
                                   itemsize=din.itemsize, weighted=wt,
                                   accum_itemsize=dacc.itemsize)
        assert got == want, (din, dacc, bn, nbuf, wt)
    assert tune.smem_budget(cuda) == tune.SMEM_BUDGET


@pytest.mark.cuda
def test_cuda_ring_refuses_a_ring_beyond_shared_memory(cuda):
    x = torch.rand(4, 70000, device=cuda)
    with pytest.raises(RuntimeError, match="moments_packed_ring launch"):
        K.moments_packed_ring(x, x, degree=3, block_n=4096, nbuf=4)


@pytest.mark.cuda
def test_cuda_ring_through_ops_and_tuner(cuda):
    from repro_torch.kernels import ops, tune
    tune.clear_cache()
    x = torch.rand(3, 4, 20000, device=cuda) * 2 - 1
    y = 1 + x - x ** 3
    bn = tune.autotune_block_n(3, 4096, device=cuda)
    assert bn in tune.feasible_blocks(3)
    assert tune.autotune_block_n(3, device=cuda) == bn   # cached
    K.reset_launch_counts()
    m0 = ops.moments(x, y, 3, packing="packed")
    m2 = ops.moments(x, y, 3, packing="packed", nbuf=2, block_n=bn)
    assert K.launch_counts()["moments_packed_ring"] == 1
    for f in ("gram", "vty", "yty", "count", "weight_sum"):
        assert torch.equal(getattr(m0, f), getattr(m2, f)), f
    assert m2.gram.shape == (3, 4, 4, 4)


@pytest.mark.cuda
def test_cuda_stream_snapshot_restore_is_bit_equal(cuda):
    from repro_torch import api
    from repro_torch.core import streaming
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand(64, 8 * 4096, generator=g, device=cuda) * 4 - 2
    y = 0.5 - x + 0.75 * x ** 3 + 0.1 * torch.randn(
        x.shape, generator=g, device=cuda)
    spec = api.FitSpec(degree=api.DegreeSearch(max_degree=5, folds=3),
                       decay=0.9999, domain=(0.0, 0.5))
    st = api.stream_state(spec, (64,))
    assert streaming.update_plan(st, (64, 4096), x.dtype).path \
        == "kernel_packed"
    K.reset_launch_counts()
    snap = None
    for i in range(8):
        st = streaming.update(st, x[:, i * 4096:(i + 1) * 4096],
                              y[:, i * 4096:(i + 1) * 4096])
        if i == 3:
            snap = st.snapshot()
    assert K.launch_counts()["moments_packed"] == 8
    rs = streaming.StreamState.restore(snap, spec=spec)
    for i in range(4, 8):
        rs = streaming.update(rs, x[:, i * 4096:(i + 1) * 4096],
                              y[:, i * 4096:(i + 1) * 4096])
    for a, b in ((rs.moments, st.moments), (rs.fold_moments,
                                            st.fold_moments)):
        for f in ("gram", "vty", "yty", "count", "weight_sum"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(api.stream_result(rs).best_degree,
                          api.stream_result(st).best_degree)


@pytest.mark.cuda
def test_cuda_stream_plans_by_shape(cuda):
    """A batch of series takes the packed kernel, one long series the
    plain kernel, one short series the reference path: on CUDA tensors,
    with no device argument."""
    from repro_torch import api
    from repro_torch.core import streaming
    x = torch.rand(1 << 16, device=cuda) * 2 - 1
    y = 1 + x - x ** 3
    for shape, path, kernel in (((4, 1 << 14), "kernel_packed",
                                 "moments_packed"),
                                ((1 << 16,), "kernel_plain", "moments_plain"),
                                ((1000,), "reference", None)):
        st = api.stream_state(api.FitSpec(degree=3), shape[:-1])
        assert streaming.update_plan(st, shape, x.dtype).path == path
        K.reset_launch_counts()
        st = streaming.update(st, x[:shape[-1]].expand(shape),
                              y[:shape[-1]].expand(shape))
        counts = K.launch_counts()
        assert sum(counts.values()) == (kernel is not None)
        if kernel:
            assert counts[kernel] == 1
        res = api.stream_result(st)
        np.testing.assert_allclose(res.coeffs.reshape(-1, 4)[0].cpu().numpy(),
                                   [1.0, 1.0, 0.0, -1.0], atol=1e-3)


@pytest.mark.cuda
def test_cuda_fit_server_ingest_solve_bit_equals_solve(cuda):
    """Every bucket ingest on the card is one packed-kernel launch (plus
    stream_sweeps − 1 per robust step), and the fused ingest+solve answers
    the default spec with the bits of the standalone solve."""
    from repro_torch import api, engine
    from repro_torch.core import streaming
    from repro_torch.serve import FitServeConfig, FitServeEngine
    eng = FitServeEngine(FitServeConfig(degree=3, n_slots=8,
                                        buckets=(256, 4096)))
    for b in eng.buckets:
        assert streaming.update_plan(b.state, (8, b.width),
                                     torch.float32).path == "kernel_packed"
    warm = eng.warmup()
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(40):
        n = int(rng.integers(8, 9000))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (1 + x - x ** 3 + 0.01 * rng.normal(size=n)).astype(np.float32)
        spec = api.FitSpec(degree=3, method="irls") if i % 5 == 4 else None
        reqs.append(eng.submit(x, y, spec=spec))
    engine.reset_moment_counter()
    K.reset_launch_counts()
    eng.run()
    assert all(r.done for r in reqs)
    assert K.launch_counts()["moments_packed"] \
        == engine.moment_counter()["calls"] > 0
    assert eng.compiled_executables() == warm + 1     # the IRLS spec
    for r in reqs:
        if r.spec.method == "lse":
            np.testing.assert_allclose(r.coeffs, [1, 1, 0, -1], atol=2e-2)
    # the last state of the widest bucket, solved standalone
    b = eng.buckets[-1]
    fused = eng.buckets[-1].ingest_solve.fn
    st = b.state
    args = (torch.zeros(8, b.width, device=cuda),) * 3 + (
        torch.ones(8, device=cuda), np.zeros(8, np.float32),
        torch.zeros(8, dtype=torch.int32, device=cuda),
        torch.ones(8, device=cuda))
    st2, out = fused(st, *args)
    alone = eng._solve(st2, eng.fixed_spec)
    for a, c in zip(out, alone):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [1, 3, 20])
def test_cuda_packed_kernel_at_one_point_per_series(cuda, degree):
    """The fleet's step-time monitor updates (n_workers, 1) batches, which
    the planner gives the packed kernel: one point per series."""
    from repro_torch.core import streaming
    g = torch.Generator(device=cuda).manual_seed(degree)
    x = torch.rand(4, 1, generator=g, device=cuda) * 4 - 2
    y = torch.randn(4, 1, generator=g, device=cuda)
    w = torch.tensor([[1.0], [0.0], [0.5], [2.0]], device=cuda)
    for wc in (None, w):
        want = K.moments_block_plain(x, y, wc, degree, torch.float64)
        for fn in (K.moments_plain, K.moments_packed):
            got = fn(x, y, wc, degree=degree)
            err = (got.double() - want).abs().amax((1, 2))
            assert bool((err <= 1e-5 * want.abs().amax((1, 2))).all())
    st = streaming.StreamState.create(1, (4,), decay=0.98)
    assert streaming.update_plan(st, (4, 1), torch.float32).path \
        == "kernel_packed"


def _fleet_traffic(k, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(lo, hi))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (0.5 - x + 0.25 * x ** 2 + 0.75 * x ** 3
             + 0.1 * rng.normal(size=n)).astype(np.float32)
        out.append((x, y))
    return out


@pytest.mark.cuda
def test_cuda_fleet_ingest_plans_the_plain_kernel(cuda):
    """At chunk_width 2^16 every fleet ingest is one weighted moments_plain
    launch; results leave the worker as host numpy."""
    from repro_torch.core import streaming
    from repro_torch.serve import fit_engine as fe
    from repro_torch.serve.fleet import FleetWorker, Ingest, Solve
    specs = fe.derive_pool_specs(fe.FitServeConfig(degree=3))
    wk = FleetWorker(0, specs, torch.float32, fe.make_spec_solve(3),
                     fe.make_spec_sweep(3))
    st = streaming.StreamState.create(3, spec=specs.fixed)
    assert streaming.update_plan(st, (1 << 16,), torch.float32).path \
        == "kernel_plain"
    (x, y), = _fleet_traffic(1, 70000, 70001)
    w = np.zeros(1 << 17, np.float32)
    w[:len(x)] = 1.0
    xp = np.zeros_like(w)
    yp = np.zeros_like(w)
    xp[:len(x)], yp[:len(y)] = x, y
    K.reset_launch_counts()
    for seq in (1, 2):
        sl = slice((seq - 1) << 16, seq << 16)
        wk.process(Ingest(1, seq, xp[sl], yp[sl], w[sl], specs.fixed), seq)
    assert K.launch_counts()["moments_plain"] == 2
    [res] = wk.process(Solve(1, specs.fixed), 3)
    assert all(isinstance(a, np.ndarray) for a in res.fixed)
    assert float(res.fixed[3]) == len(x)
    np.testing.assert_allclose(res.fixed[0], [0.5, -1, 0.25, 0.75],
                               atol=2e-2)


@pytest.mark.cuda
def test_cuda_fleet_chaos_parity(cuda):
    """Under a seeded schedule of every fault kind the fleet on the card
    returns coefficients bit-equal to its fault-free run, and the parallel
    pump equals the serial one."""
    from repro_torch.runtime import FAULT_KINDS, ChaosSchedule
    from repro_torch.serve import FitFleet, FitServeConfig, FleetConfig
    traffic = _fleet_traffic(24, 1 << 15, 1 << 18)

    def run(chaos=None, parallel=False):
        fleet = FitFleet(FleetConfig(
            fit=FitServeConfig(degree=3), n_workers=4, chunk_width=1 << 16,
            chaos=chaos, straggler_threshold=2.0, parallel_pump=parallel))
        reqs = [fleet.submit(x, y) for x, y in traffic]
        reqs.append(fleet.submit(*traffic[0], degree="auto"))
        h = fleet.submit_async_lspia(*traffic[1], n_shards=4)
        K.reset_launch_counts()
        fleet.run(max_ticks=20_000)
        fleet.close()
        return fleet, reqs, h, K.launch_counts()

    base, breqs, bh, blaunch = run()
    chaos = ChaosSchedule.parse("crash=1,stall=1,poison=1,drop=1,delay=1",
                                0, 4, horizon=16)
    fleet, reqs, h, launches = run(chaos)
    assert {e.kind for w in fleet.workers for e in w.faults_applied} \
        == set(FAULT_KINDS)
    assert fleet.stats["failed"] == 0 and fleet.stats["worker_deaths"] == 1
    assert blaunch["moments_plain"] > 0 and launches["moments_plain"] > 0
    for b, c in zip(breqs, reqs):
        assert c.done and c.failed is None and c.count == b.count
        np.testing.assert_array_equal(c.coeffs, b.coeffs)
    np.testing.assert_array_equal(h.coeffs, bh.coeffs)
    _, preqs, ph, plaunch = run(parallel=True)
    assert plaunch == blaunch
    for b, c in zip(breqs, preqs):
        np.testing.assert_array_equal(c.coeffs, b.coeffs)
    np.testing.assert_array_equal(ph.coeffs, bh.coeffs)


@pytest.mark.cuda
def test_cuda_launch_serve_fleet_assert_parity(cuda, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--workload", "fleet", "--assert-parity"]) == 0
    assert "parity OK" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_one_rank_nccl_mesh_fit_matches_eager(cuda, tmp_path):
    """A 1-rank NCCL mesh on the card: the shard's moment pass launches
    moments_plain, the fold stack of a search the kernel plan_fit picks,
    and the results match eager api.fit (the κ-scaled bound of
    tests/test_api.py; the same degree)."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch import api, engine
    from repro_torch.launch import mesh as mesh_lib
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        mesh = mesh_lib.make_host_mesh(data=1)
        g = torch.Generator(device=cuda).manual_seed(5)
        x = torch.rand(1 << 20, generator=g, device=cuda) * 4 - 2
        y = 0.5 - x + 0.75 * x ** 3 + 0.1 * torch.randn(
            x.shape, generator=g, device=cuda)
        for spec, kernel in (
                (api.FitSpec(degree=3), "moments_plain"),
                (api.FitSpec(degree=api.DegreeSearch(max_degree=6,
                                                     folds=5)),
                 "moments_packed")):
            K.reset_launch_counts()
            engine.reset_collective_counter()
            got = spec.distributed(mesh)(x, y)
            assert K.launch_counts()[kernel] == 1
            assert engine.collective_counter()["calls"] >= 1
            want = api.fit(x, y, spec)
            assert got.best_degree == want.best_degree
            kappa = float(want.poly.diagnostics.condition.max())
            c = want.coeffs.cpu().numpy()
            tol = 200 * kappa * np.finfo(np.float32).eps * max(
                1.0, float(np.abs(c).max()))
            # a mesh search keeps the zero-padded (max_degree+1) layout
            np.testing.assert_allclose(got.coeffs.cpu().numpy()[:c.size],
                                       c, rtol=0, atol=tol)
    finally:
        dist.destroy_process_group()


ZOO_ARCHS = ("dbrx-132b", "phi3.5-moe-42b-a6.6b", "internlm2-1.8b", "yi-6b",
             "qwen1.5-4b", "gemma2-27b", "llava-next-mistral-7b")


def _zoo(arch, compute_dtype):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import get_model
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              compute_dtype=compute_dtype)
    return cfg, get_model(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_cuda_zoo_matches_the_cpu(cuda, arch):
    """The same seeded weights on the card and on the CPU: forward_train,
    prefill and decode_step agree within 1e-5 of max|ref| at float32
    compute (TF32 off; two float32 orders of the same sums).  MoE
    configs' routing is a discrete choice on float32 probabilities, held
    by the same bar."""
    assert not torch.backends.cuda.matmul.allow_tf32
    import copy
    cfg, model = _zoo(arch, "float32")
    cpu_params = model.init_params(0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(cuda)   # Module.to moves
    assert next(cpu_params.parameters()).device.type == "cpu"
    g = np.random.default_rng(1)
    toks = torch.from_numpy(g.integers(3, cfg.vocab_size, (2, 32)))
    batch = {"tokens": toks}
    if cfg.n_image_tokens:
        batch["extra_embeds"] = torch.from_numpy(g.normal(
            0, 1, (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    on = lambda b, dev: {k: v.to(dev) for k, v in b.items()}

    def close(got, want):
        assert got.device.type == "cuda"
        got, want = got.float().cpu(), want.float()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err

    close(model.forward_train(gpu_params, on(batch, cuda))[0],
          model.forward_train(cpu_params, batch)[0])
    pre = dict(batch, tokens=toks[:, :-1])
    glog, gstate = model.prefill(gpu_params, on(pre, cuda), 40)
    clog, cstate = model.prefill(cpu_params, pre, 40)
    close(glog, clog)
    assert gstate["k"].device.type == "cuda"
    close(model.decode_step(gpu_params, toks[:, -1:].to(cuda), gstate)[0],
          model.decode_step(cpu_params, toks[:, -1:], cstate)[0])


@pytest.mark.cuda
def test_cuda_engine_serves_the_cpu_tokens(cuda):
    """Greedy serving of ragged requests past max_len (the clamp) on the
    card and on the CPU: the same tokens for every request."""
    import copy

    from repro_torch.serve import EngineConfig, ServeEngine
    cfg, model = _zoo("internlm2-1.8b", "float32")
    cpu_params = model.init_params(0, device="cpu")
    g = np.random.default_rng(2)
    prompts = [g.integers(3, 255, 5 + 4 * (i % 3)).tolist()
               for i in range(10)]
    outs = []
    for params in (cpu_params, copy.deepcopy(cpu_params).to(cuda)):
        eng = ServeEngine(model, params, EngineConfig(n_slots=4, max_len=24))
        reqs = [eng.submit(p, 4 + (5 * i) % 13, 0.0)
                for i, p in enumerate(prompts)]
        eng.run()
        assert all(r.done for r in reqs) and eng.stats["peak_len"] > 24
        assert eng.state["k"].device == next(params.parameters()).device
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_cuda_launch_serve_tokens_smoke(cuda, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--workload", "tokens", "--smoke"]) == 0
    assert "on cuda" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_cuda_train_step_matches_the_cpu(cuda, arch):
    """One train step from the same state on the card and on the CPU at
    float32 compute (TF32 off): loss and grad_norm within 1e-5 relative,
    mu (0.1 · the clipped gradient) within 1e-5 · max|mu|, the parameters
    within 2·lr + 1e-5 · max|p| (Adam's first step moves an element whose
    gradient is near 0 by ±lr, and two float32 orders of the same sum
    can give it either sign)."""
    import copy

    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    cfg, model = _zoo(arch, "float32")
    cpu = init_train_state(model, 0, device="cpu")
    gpu = copy.deepcopy(cpu)
    gpu["params"].to(cuda)
    gpu["opt"] = {"mu": {k: v.to(cuda) for k, v in cpu["opt"]["mu"].items()},
                  "nu": {k: v.to(cuda) for k, v in cpu["opt"]["nu"].items()},
                  "count": cpu["opt"]["count"].to(cuda)}
    gpu["step"] = cpu["step"].to(cuda)
    g = np.random.default_rng(3)
    st = 32 + cfg.n_image_tokens
    batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab_size,
                                                   (2, 32))),
             "labels": torch.from_numpy(g.integers(0, cfg.vocab_size,
                                                   (2, st))),
             "loss_mask": torch.ones(2, st)}
    if cfg.n_image_tokens:
        batch["extra_embeds"] = torch.from_numpy(g.normal(
            0, 1, (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    step = make_train_step(model, TrainConfig())
    cpu, cm = step(cpu, batch)
    gpu, gm = step(gpu, {k: v.to(cuda) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert gm[k].device.type == "cuda"
        assert abs(float(gm[k]) - float(cm[k])) <= 1e-5 * abs(float(cm[k]))
    lr = float(cm["lr"])
    for (n, p), (_, q) in zip(gpu["params"].named_parameters(),
                              cpu["params"].named_parameters()):
        err = (p.cpu() - q).abs().max().item()
        assert err <= 2 * lr + 1e-5 * q.abs().max().item(), n
        mu, want = gpu["opt"]["mu"][n].cpu(), cpu["opt"]["mu"][n]
        assert (mu - want).abs().max().item() <= \
            1e-5 * want.abs().max().item(), n


@pytest.mark.cuda
def test_cuda_launch_train_smoke_resumes(cuda, tmp_path, capsys):
    """The train launcher on the card: 8 steps with checkpoints at 4 and 8;
    with step 8's gone it resumes at 4 and replays the same losses (the
    reference's rtol 1e-5: the embedding's backward sums with atomics)."""
    import shutil

    from repro_torch.launch import train
    argv = ["--smoke", "--steps", "8", "--ckpt-every", "4",
            "--ckpt-dir", str(tmp_path), "--microbatches", "2"]
    whole = train.run(argv)
    assert "device=cuda" in capsys.readouterr().out
    shutil.rmtree(tmp_path / "step_00000008")
    resumed = train.run(argv)
    assert resumed["start_step"] == 4
    np.testing.assert_allclose([resumed["losses"][s] for s in range(4, 8)],
                               [whole["losses"][s] for s in range(4, 8)],
                               rtol=1e-5)


FAMILY_ARCHS = ("rwkv6-1.6b", "zamba2-7b", "whisper-base")


def _family_batch(cfg, b, s, seed):
    """Tokens (whisper: 24 frames and the decoder's tokens) and the key of
    the tokens."""
    g = np.random.default_rng(seed)
    toks = torch.from_numpy(g.integers(3, cfg.vocab_size, (b, s)))
    if cfg.family == "audio":
        return {"frames": torch.from_numpy(g.normal(
            0, 1, (b, 24, cfg.d_model)).astype(np.float32)),
            "dec_tokens": toks}, "dec_tokens"
    return {"tokens": toks}, "tokens"


def _state_tensors(state, prefix=""):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from _state_tensors(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + k, v


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_family_matches_the_cpu(cuda, arch):
    """The float32 checks of chip_smoke's 16a, 16d and 16e at the smoke
    configs: the same seeded weights on the card and on the CPU,
    forward_train, prefill and decode_step within 1e-5 of max|ref| (TF32
    off; two float32 orders of the same sums), every float32 leaf of the
    prefill state too, its bf16 leaves (K/V, shift inputs, whisper's
    encoder output) within one bf16 step (2⁻⁷).  Both decode from the
    CPU's prefill state (the card's copy of it): a bf16 leaf rounded to
    the neighbouring step on one device would otherwise move every
    product that reads it."""
    import copy
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _zoo(arch, "float32")
    cpu_params = model.init_params(0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(cuda)
    batch, key = _family_batch(cfg, 2, 32, 1)
    on = lambda b, dev: {k: v.to(dev) for k, v in b.items()}

    def close(name, got, want, tol=1e-5):
        assert got.device.type == "cuda", name
        got, want = got.float().cpu(), want.float()
        err = (got - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (name, err)

    close("forward_train", model.forward_train(gpu_params, on(batch, cuda))[0],
          model.forward_train(cpu_params, batch)[0])
    pre = dict(batch, **{key: batch[key][:, :-1]})
    glog, gstate = model.prefill(gpu_params, on(pre, cuda), 40)
    clog, cstate = model.prefill(cpu_params, pre, 40)
    close("prefill", glog, clog)
    cleaves = dict(_state_tensors(cstate))
    for name, t in _state_tensors(gstate):
        close(name, t, cleaves[name], 2.0 ** -7 if t.dtype == torch.bfloat16
              else 1e-5)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else
                v.to(cuda) if isinstance(v, torch.Tensor) else v
                for k, v in tree.items()}

    tok = batch[key][:, -1:]
    gdec = model.decode_step(gpu_params, tok.to(cuda), to_card(cstate))[0]
    close("decode_step", gdec, model.decode_step(cpu_params, tok, cstate)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_family_prefill_decode_match_forward_train(cuda, arch):
    """The bf16 consistency of chip_smoke's 16a, 16d and 16e at the smoke
    configs, on the card: prefill of s - 1 tokens on the compute copy and
    one decode step against forward_train of s, within the reference's
    5e-2 of max|ref|."""
    cfg, model = _zoo(arch, "bfloat16")
    params = model.init_params(0, device=cuda)
    cp = model.compute_params(params)
    batch, key = _family_batch(cfg, 2, 24, 2)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    full, _ = model.forward_train(params, batch)
    logits, state = model.prefill(cp, dict(batch, **{key: batch[key][:, :-1]}),
                                  32)
    dec, state = model.decode_step(cp, batch[key][:, -1:], state)
    for got, want in ((logits[:, 0], full[:, -2]), (dec[:, 0], full[:, -1])):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item(), err
    assert all(t.device.type == "cuda" for _, t in _state_tensors(state))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("rwkv6-1.6b", "zamba2-7b"))
def test_cuda_family_engine_serves_the_cpu_tokens(cuda, arch):
    """Greedy serving of ragged requests past max_len on the card and on
    the CPU at float32: the same tokens for every request, the pooled
    recurrent state (and zamba2's shared K/V) on the card."""
    import copy

    from repro_torch.serve import EngineConfig, ServeEngine
    cfg, model = _zoo(arch, "float32")
    cpu_params = model.init_params(0, device="cpu")
    g = np.random.default_rng(2)
    prompts = [g.integers(3, 255, 5 + 4 * (i % 3)).tolist()
               for i in range(10)]
    outs = []
    for params in (cpu_params, copy.deepcopy(cpu_params).to(cuda)):
        eng = ServeEngine(model, params, EngineConfig(n_slots=4, max_len=24))
        reqs = [eng.submit(p, 4 + (5 * i) % 13, 0.0)
                for i, p in enumerate(prompts)]
        eng.run()
        assert all(r.done for r in reqs) and eng.stats["peak_len"] > 24
        dev = next(params.parameters()).device
        assert all(t.device == dev for _, t in _state_tensors(eng.state))
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
