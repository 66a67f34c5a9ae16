"""The zoo's recurrent, hybrid and audio families on the port against the
JAX reference, on the CPU: RWKV6 blocks, the Mamba2 mixer (its conv tail
carried into decode), and the rwkv6, zamba2 and whisper models end to
end on the reference's weights (``interop.model_params``), each from its
smoke config; then each port model's prefill + decode against its own
forward_train, Whisper's ``dec_pos`` clamp, the audio API's input specs
and token counts, and the interop round trips.

Bars (as ``tests/test_torch_models.py``): float32 compute, max|Δ| <=
1e-5 · max|ref|; the configs' bf16 compute, 5e-2 · max|ref| (the
reference's bf16 bar, ``tests/test_arch_smoke.py``).  A decode state's
recurrent leaves are float32 in both packages (1e-5); its bf16 K/V or
shift inputs written from float32 compute within one bf16 step (2⁻⁷).
The port's own prefill + decode against its forward_train is held to the
bf16 bar: the K/V cache is bf16 even at float32 compute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import get_model as rget_model
from repro.models import mamba2 as rmamba2
from repro.models import rwkv6 as rrwkv6
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import get_model as tget_model
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import rwkv6 as trwkv6

torch.set_num_threads(1)

CPU = "cpu"
F32_TOL = 1e-5
BF16_TOL = 5e-2
CACHE_TOL = 2.0 ** -7
FAMILY_ARCHS = ["rwkv6-1.6b", "zamba2-7b", "whisper-base"]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"max|Δ| {err:.3e} > {tol:g}·{scale:.3e}"


TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}


def pair(x, dtype):
    return (jnp.asarray(x, jnp.float32).astype(JAX_DTYPE[dtype]),
            torch.from_numpy(np.asarray(x, np.float32)).to(TORCH_DTYPE[dtype]))


def load(mod, tree):
    """A reference parameter dict as ``mod``'s float32 parameters."""
    for k, v in tree.items():
        if isinstance(v, dict):
            load(getattr(mod, k), v)
        else:
            setattr(mod, k, torch.nn.Parameter(
                torch.from_numpy(np.array(v, np.float32)),
                requires_grad=False))
    return mod


def _perturb(tree, rng, names):
    """``names``' leaves of a reference tree redrawn (the inits leave the
    bonus at 0 and every decay at one value)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, names)
        elif k in names:
            out[k] = jnp.asarray(names[k](rng, v.shape), v.dtype)
        else:
            out[k] = v
    return out


RWKV_REDRAW = {
    "bonus": lambda r, s: r.normal(0, 1, s),
    "decay_w0": lambda r, s: r.uniform(-4.0, 0.0, s),
    "mix": lambda r, s: r.uniform(0.0, 1.0, s),
    "mix_w": lambda r, s: r.uniform(0.0, 1.0, s),
}
MAMBA_REDRAW = {
    "dt_bias": lambda r, s: r.normal(0, 1, s),
    "d_skip": lambda r, s: r.normal(1, 0.5, s),
    "conv_b": lambda r, s: r.normal(0, 0.1, s),
}


def _state_pair(rstate, dtype):
    """A reference per-layer state as the port's (float32 leaves stay
    float32; the shift inputs in the compute dtype)."""
    return {k: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else TORCH_DTYPE[dtype])
        for k, v in rstate.items()}


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_block_parity(dtype):
    """block_train, block_prefill (from a carried state, ragged 37 tokens
    over chunks of 16) and block_decode against the reference."""
    rcfg = rrwkv6.RWKV6Config(d_model=64, head_dim=16, d_ff=128,
                              decay_lora=8, chunk=16)
    tcfg = trwkv6.RWKV6Config(**dataclasses.asdict(rcfg))
    rp = _perturb(rrwkv6.init(jax.random.PRNGKey(0), rcfg),
                  np.random.default_rng(1), RWKV_REDRAW)
    tp = load(trwkv6.init(tcfg, device="meta"), rp)
    r = np.random.default_rng(2)
    rx, tx = pair(r.normal(0, 1, (2, 37, 64)), dtype)
    tol = TOL[dtype]
    close(trwkv6.block_train(tp, tcfg, tx),
          jax.jit(rrwkv6.block_train, static_argnums=1)(rp, rcfg, rx), tol)

    rs0 = rrwkv6.init_state(rcfg, 2, JAX_DTYPE[dtype])
    rs0 = {"att_x": pair(r.normal(0, 1, (2, 1, 64)), dtype)[0],
           "ffn_x": pair(r.normal(0, 1, (2, 1, 64)), dtype)[0],
           "wkv": jnp.asarray(r.normal(0, 1, rs0["wkv"].shape), jnp.float32)}
    ro, rs = jax.jit(rrwkv6.block_prefill, static_argnums=1)(rp, rcfg, rx,
                                                            rs0)
    to, ts = trwkv6.block_prefill(tp, tcfg, tx, _state_pair(rs0, dtype))
    close(to, ro, tol)
    for k in rs:
        assert ts[k].dtype == (torch.float32 if k == "wkv"
                               else TORCH_DTYPE[dtype]), k
        close(ts[k], rs[k], tol)

    rx1, tx1 = pair(r.normal(0, 1, (2, 1, 64)), dtype)
    ro, rs2 = jax.jit(rrwkv6.block_decode, static_argnums=1)(rp, rcfg, rx1,
                                                            rs)
    to, ts2 = trwkv6.block_decode(tp, tcfg, tx1, _state_pair(rs, dtype))
    close(to, ro, tol)
    for k in rs2:
        close(ts2[k], rs2[k], tol)


def _mamba(dtype):
    rcfg = rmamba2.Mamba2Config(d_model=32, d_state=16, head_dim=16,
                                chunk=16)
    tcfg = tmamba2.Mamba2Config(**dataclasses.asdict(rcfg))
    rp = _perturb(rmamba2.init(jax.random.PRNGKey(3), rcfg),
                  np.random.default_rng(4), MAMBA_REDRAW)
    return rcfg, tcfg, rp, load(tmamba2.init(tcfg, device="meta"), rp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_parity_with_the_conv_tail(dtype):
    """apply_train on a ragged 29-token sequence; apply_prefill from a
    non-zero state (conv tail and SSD state); then three apply_decode
    steps, each carrying the (b, W-1, c) conv tail and the SSD state of
    the step before, against the reference's."""
    rcfg, tcfg, rp, tp = _mamba(dtype)
    r = np.random.default_rng(5)
    rx, tx = pair(r.normal(0, 1, (2, 29, 32)), dtype)
    tol = TOL[dtype]
    close(tmamba2.apply_train(tp, tcfg, tx),
          jax.jit(rmamba2.apply_train, static_argnums=1)(rp, rcfg, rx), tol)

    shapes = rmamba2.init_state(rcfg, 2)
    rconv, tconv = pair(r.normal(0, 1, shapes["conv"].shape), dtype)
    ssm = r.normal(0, 1, shapes["ssm"].shape).astype(np.float32)
    rs = {"conv": rconv, "ssm": jnp.asarray(ssm)}
    ts = {"conv": tconv, "ssm": torch.from_numpy(ssm)}
    ro, rs = jax.jit(rmamba2.apply_prefill, static_argnums=1)(rp, rcfg, rx,
                                                             rs)
    to, ts = tmamba2.apply_prefill(tp, tcfg, tx, ts)
    close(to, ro, tol)
    assert ts["conv"].shape == (2, tcfg.conv_width - 1,
                                tcfg.d_inner + 2 * tcfg.d_state)
    close(ts["conv"], rs["conv"], tol)
    close(ts["ssm"], rs["ssm"], tol)
    # the tail is the prefill's last W-1 conv inputs
    proj = torch.einsum("bsd,de->bse", tx, tp.w_in.to(tx.dtype))
    assert torch.equal(ts["conv"], tmamba2._split_proj(tcfg, proj)[1][:, -3:])
    for step in range(3):
        rx1, tx1 = pair(r.normal(0, 1, (2, 1, 32)), dtype)
        ro, rs = jax.jit(rmamba2.apply_decode, static_argnums=1)(rp, rcfg,
                                                                rx1, rs)
        to, ts = tmamba2.apply_decode(tp, tcfg, tx1, ts)
        close(to, ro, tol)
        close(ts["ssm"], rs["ssm"], tol)
        close(ts["conv"], rs["conv"], tol)


def test_mamba2_decode_steps_continue_the_prefill():
    """Prefill of s tokens then decode of one equals prefill of s + 1
    (float32): the carried conv tail and SSD state lose nothing."""
    _, tcfg, _, tp = _mamba("float32")
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, 21, 32)).astype(np.float32))
    zero = tmamba2.init_state(tcfg, 1)
    whole, _ = tmamba2.apply_prefill(tp, tcfg, x, zero)
    part, st = tmamba2.apply_prefill(tp, tcfg, x[:, :20],
                                     tmamba2.init_state(tcfg, 1))
    last, _ = tmamba2.apply_decode(tp, tcfg, x[:, 20:], st)
    close(part, whole[:, :20])
    close(last, whole[:, 20:])


# ------------------------------------------------------------------ models
def _configs(arch, dtype):
    rc, tc = rconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    return (dataclasses.replace(rc, compute_dtype=dtype),
            dataclasses.replace(tc, compute_dtype=dtype))


def _ref_params(rm, arch):
    rparams = rm.init_params(jax.random.PRNGKey(0))
    if arch == "rwkv6-1.6b":
        rparams = _perturb(rparams, np.random.default_rng(8), RWKV_REDRAW)
    return rparams


def _batches(cfg, b, s, seed=2):
    """(reference batch, port batch) of the full sequence and of its prompt
    (all but the last token), and the last token."""
    r = np.random.default_rng(seed)
    toks = r.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    key = "dec_tokens" if cfg.family == "audio" else "tokens"
    full, pre = {key: toks}, {key: toks[:, :-1]}
    if cfg.family == "audio":
        full["frames"] = pre["frames"] = r.normal(
            0, 1, (b, 24, cfg.d_model)).astype(np.float32)
    both = lambda d: ({k: jnp.asarray(v) for k, v in d.items()},
                      {k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in d.items()})
    return both(full), both(pre), toks[:, -1:]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_parity(arch, dtype):
    """forward_train, prefill (on the compute copy) and decode_step of the
    port against the reference on the reference's weights; the prefill
    state against the reference's, leaf by leaf; decode from the carried
    reference state."""
    rc, tc = _configs(arch, dtype)
    rm, tm = rget_model(rc), tget_model(tc)
    rparams = _ref_params(rm, arch)
    tparams = interop.model_params(rparams, tc, device=CPU)
    (rb, tb), (rpre, tpre), tok = _batches(tc, 2, 32)
    tol = TOL[dtype]

    rfull, _ = jax.jit(rm.forward_train)(rparams, rb)
    tfull, taux = tm.forward_train(tparams, tb)
    close(tfull, rfull, tol)
    assert float(taux) == 0.0

    rlog, rstate = jax.jit(rm.prefill, static_argnums=2)(rparams, rpre, 40)
    tlog, tstate = tm.prefill(tm.compute_params(tparams), tpre, 40)
    close(tlog, rlog, tol)
    carried = interop.decode_state(rstate, tc, device=CPU)
    assert tstate["len"] == carried["len"] == int(rstate["len"]) == 31
    want = dict(_leaves({k: v for k, v in carried.items() if k != "len"}))
    got = dict(_leaves({k: v for k, v in tstate.items() if k != "len"}))
    assert got.keys() == want.keys()
    for name, t in got.items():
        bf16_leaf = want[name].dtype == torch.bfloat16
        close(t, want[name], tol if dtype == "bfloat16" or not bf16_leaf
              else CACHE_TOL)

    rdec, _ = jax.jit(rm.decode_step)(rparams, jnp.asarray(tok), rstate)
    tdec, tnext = tm.decode_step(tparams, torch.from_numpy(tok), carried)
    close(tdec, rdec, tol)
    assert tnext["len"] == 32


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_and_decode_match_forward_train(arch):
    """The port's own consistency at the config's bf16 compute: prefill of
    s - 1 tokens and one decode step against forward_train of s."""
    _, tc = _configs(arch, "bfloat16")
    tm = tget_model(tc)
    params = tm.init_params(0, device=CPU)
    cp = tm.compute_params(params)
    (_, tb), (_, tpre), tok = _batches(tc, 2, 24, seed=3)
    full, _ = tm.forward_train(params, tb)
    logits, state = tm.prefill(cp, tpre, 32)
    dec, state = tm.decode_step(cp, torch.from_numpy(tok), state)
    close(logits[:, 0], full[:, -2], BF16_TOL)
    close(dec[:, 0], full[:, -1], BF16_TOL)
    assert state["len"] == 24
    for out in (full, logits, dec):
        assert bool(torch.isfinite(out.float()).all())


def test_compute_copy_keeps_the_float32_reads():
    """bf16 copies of every weight the reference casts at its products;
    float32 (shared with the masters) for the norms and the leaves it
    reads in float32: rwkv6's decay LoRA and bonus, Mamba2's a_log and
    dt_bias.  The forward pass on the copy equals the one on the masters."""
    f32 = {"rwkv6-1.6b": ("decay_w0", "decay_a", "decay_b", "bonus"),
           "zamba2-7b": ("a_log", "dt_bias"), "whisper-base": ()}
    for arch, names in f32.items():
        tc = tconfigs.get_smoke_config(arch)
        tm = tget_model(tc)
        params = tm.init_params(0, device=CPU)
        copy = tm.compute_params(params)
        norms = {n for n, m in params.named_modules()
                 if type(m).__name__ in ("RMSNorm", "LayerNorm")}
        for (name, p), (_, c) in zip(params.named_parameters(),
                                     copy.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            keep = owner in norms or leaf in names
            assert c.dtype == (torch.float32 if keep else torch.bfloat16), \
                (arch, name)
            if keep:
                assert c.data_ptr() == p.data_ptr(), (arch, name)
            else:
                assert torch.equal(c, p.to(c.dtype)), (arch, name)
        (_, tb), _, _ = _batches(tc, 2, 16)
        a, _ = tm.forward_train(params, tb)
        b, _ = tm.forward_train(copy, tb)
        assert torch.equal(a, b), arch


# ------------------------------------------------------------------ whisper
def test_whisper_dec_pos_clamps_past_its_rows():
    """Decode at a pooled length past dec_pos's 8192 rows reads the last
    row, as the reference's dynamic_slice clamps; the logits equal the
    reference's from the same carried state, and equal a decode at
    length 8191 save for the self-attention mask (here the cache's rows
    are all valid either way)."""
    rc, tc = _configs("whisper-base", "float32")
    rm, tm = rget_model(rc), tget_model(tc)
    rparams = rm.init_params(jax.random.PRNGKey(0))
    tparams = interop.model_params(rparams, tc, device=CPU)
    (rb, _), (rpre, _), tok = _batches(tc, 2, 9)
    _, rstate = jax.jit(rm.prefill, static_argnums=2)(rparams, rpre, 8)
    outs = {}
    for length in (8191, 8200, 9000):
        rs = dict(rstate, len=jnp.asarray(length, jnp.int32))
        rdec, _ = jax.jit(rm.decode_step)(rparams, jnp.asarray(tok), rs)
        ts = interop.decode_state(rs, tc, device=CPU)
        tdec, tnext = tm.decode_step(tparams, torch.from_numpy(tok), ts)
        close(tdec, rdec)
        assert tnext["len"] == length + 1
        outs[length] = tdec
    assert torch.equal(outs[8200], outs[9000])
    close(outs[8200], outs[8191])


def test_audio_input_specs_and_batch_tokens():
    """The audio API's meta input specs equal the reference's
    ShapeDtypeStructs for every shape of the config, and batch_tokens
    counts what the reference counts (the decoder's tokens, plus the
    frames at prefill)."""
    rc, tc = rconfigs.get_config("whisper-base"), \
        tconfigs.get_config("whisper-base")
    rm, tm = rget_model(rc), tget_model(tc)
    for rshape, tshape in zip(rconfigs.shapes_for(rc),
                              tconfigs.shapes_for(tc)):
        assert tm.batch_tokens(tshape) == rm.batch_tokens(rshape)
        rspec = rm.input_specs(rshape)
        tspec = tm.input_specs(tshape)
        assert rspec.keys() == tspec.keys()
        flat_r = dict(_leaves(rspec))
        flat_t = dict(_leaves(tspec))
        assert flat_r.keys() == flat_t.keys()
        for name, t in flat_t.items():
            if name == "state.len":
                continue
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(flat_r[name].shape), name
            assert str(t.dtype).split(".")[-1] == \
                np.dtype(flat_r[name].dtype).name, name
    train = tm.input_specs(tconfigs.SHAPES["train_4k"])
    assert train["frames"].shape == (256, 4096, 512)
    assert train["dec_tokens"].shape == (256, 1024)
    assert tm.batch_tokens(tconfigs.SHAPES["train_4k"]) == 256 * 1024


def test_the_registry_serves_every_config():
    """get_model returns a model for every configuration; nothing is left
    unported."""
    from repro_torch.models import registry
    assert not hasattr(registry, "NOT_PORTED")
    for arch in tconfigs.ARCHS:
        tm = tget_model(tconfigs.get_smoke_config(arch))
        assert tm.cfg.arch.endswith("-smoke")


# ------------------------------------------------------------------ interop
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_interop_round_trips(arch):
    """model_params unstacks every reference leaf into its module (each
    value equal, no parameter left on the meta device) and stacks back to
    the reference's tree through param_shapes; decode_state carries every
    leaf and its dtype."""
    rc, tc = (dataclasses.replace(c, ssm_chunk=16)
              for c in _configs(arch, "float32"))
    rm, tm = rget_model(rc), tget_model(tc)
    rparams = rm.init_params(jax.random.PRNGKey(4))
    tparams = interop.model_params(rparams, tc, device=CPU)
    # each reference leaf's slices: the port's parameters of that path
    # without the module lists' indices, in module order (row-major)
    stacks = {}
    for key, p in tparams.named_parameters():
        assert p.device.type == "cpu"
        path = ".".join(k for k in key.split(".") if not k.isdigit())
        stacks.setdefault(path, []).append(p.numpy())
    ref = {name: np.asarray(leaf) for name, leaf in _leaves(rparams)}
    assert stacks.keys() == ref.keys()
    assert dict(_leaves(tm.param_shapes(tparams))) == {
        name: leaf.shape for name, leaf in ref.items()}
    for name, leaf in ref.items():
        got = np.stack(stacks[name]).reshape(leaf.shape)
        assert np.array_equal(got, leaf), name

    _, (rpre, _), _ = _batches(tc, 2, 12)
    _, rstate = jax.jit(rm.prefill, static_argnums=2)(rparams, rpre, 16)
    state = interop.decode_state(rstate, tc, device=CPU)
    assert state["len"] == 11
    for name, leaf in _leaves({k: v for k, v in rstate.items()
                               if k != "len"}):
        got = dict(_leaves(state))[name]
        assert str(got.dtype).split(".")[-1] == np.dtype(leaf.dtype).name
        assert np.array_equal(_np(got), _np(leaf)), name
