"""The token ServeEngine on the port against the reference engine, on the
CPU (transformers, rwkv6 and zamba2), plus sampling, the launcher's
``--workload tokens`` and the batched serving example.

Both engines run one model (the reference's weights carried with
``interop.model_params``) at float32 compute and temperature 0 over the
same ragged requests.  Every call of both runs is compared, to the last:
its logits within 1e-4 of max|ref| (the KV cache is bf16 in both
packages, and float32 K/V that differ in their last bits may round to
neighbouring bf16 values: 2⁻⁷ of one element, diluted over the softmax),
its greedy choices equal, and at the end every request's tokens.  The
smoke models' top-2 margins on these requests are far above that logit
bar, so a differing choice is a fault, not a rounding tie.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import get_model as rget_model
from repro.serve import EngineConfig as REngineConfig
from repro.serve import ServeEngine as RServeEngine
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tlaunch
from repro_torch.models import get_model as tget_model
from repro_torch.serve import EngineConfig, ServeEngine, sample

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
LOGIT_TOL = 1e-4
PROMPT_LENS = (5, 9, 13)        # three prefill shapes: three JAX compiles


def _models(arch):
    """The smoke config at float32 compute in both packages; the recurrent
    families with chunks of 16 (one sub-block of chunked_gla, whose
    off-diagonal pairs tests/test_torch_gla.py holds: the reference
    compiles in half the time)."""
    kw = {"compute_dtype": "float32"}
    if rconfigs.get_smoke_config(arch).family in ("ssm", "hybrid"):
        kw["ssm_chunk"] = 16
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), **kw)
    tc = dataclasses.replace(tconfigs.get_smoke_config(arch), **kw)
    rm, tm = rget_model(rc), tget_model(tc)
    rparams = rm.init_params(jax.random.PRNGKey(0))
    return rm, rparams, tm, interop.model_params(rparams, tc, device=CPU)


def _f32(logits):
    if isinstance(logits, torch.Tensor):
        return logits.float().numpy()
    return np.asarray(logits, np.float32)


def _record(engine, log):
    """Wrap the engine's steps to keep each call's logits, which slots held
    a request and, for decode, the pooled length it wrote its row at."""
    prefill, decode = engine._prefill, engine._decode

    def p(params, batch):
        logits, st = prefill(params, batch)
        log.append((_f32(logits), [True], None))
        return logits, st

    def d(params, tok, st):
        active = [r is not None for r in engine.slot_req]
        at = int(st["len"])
        logits, st = decode(params, tok, st)
        log.append((_f32(logits), active, at))
        return logits, st

    engine._prefill, engine._decode = p, d


def _requests(vocab, n=10, seed=0):
    r = np.random.default_rng(seed)
    return [(r.integers(3, vocab - 1, PROMPT_LENS[i % 3]).tolist(),
             4 + (5 * i) % 13) for i in range(n)]


def _serve_both(arch, max_len, requests, slots=4):
    rm, rparams, tm, tparams = _models(arch)
    reng = RServeEngine(rm, rparams, REngineConfig(n_slots=slots,
                                                   max_len=max_len))
    teng = ServeEngine(tm, tparams, EngineConfig(n_slots=slots,
                                                 max_len=max_len))
    rlog, tlog = [], []
    _record(reng, rlog)
    _record(teng, tlog)
    rreqs = [reng.submit(p, n, 0.0) for p, n in requests]
    treqs = [teng.submit(p, n, 0.0) for p, n in requests]
    reng.run()
    teng.run()
    assert all(r.done for r in rreqs) and all(t.done for t in treqs)
    return rreqs, treqs, rlog, tlog, teng


def _same_greedy_tokens(rreqs, treqs, rlog, tlog):
    """Every call of the two runs alike (the same slots, the same pooled
    length, active logits close, the same greedy choices) and every
    request's tokens equal; returns the pooled lengths the decode calls
    wrote at."""
    assert len(rlog) == len(tlog)
    written_at = []
    for i, ((r, active, at), (t, tactive, tat)) in enumerate(zip(rlog,
                                                                 tlog)):
        assert (active, at) == (tactive, tat), f"call {i}"
        rows = [j for j, a in enumerate(active) if a]
        r, t = r[rows, -1], t[rows, -1]
        assert np.abs(r - t).max() <= LOGIT_TOL * np.abs(r).max(), \
            f"call {i}"
        top2 = np.sort(r, axis=-1)[:, -2:]
        assert (r.argmax(-1) == t.argmax(-1)).all(), \
            f"call {i}: top-2 margins {top2[:, 1] - top2[:, 0]}"
        if at is not None:
            written_at.append(at)
    assert [r.out_tokens for r in rreqs] == [t.out_tokens for t in treqs]
    return written_at


@pytest.mark.parametrize("max_len, arch", [
    (m, a) for a in ("internlm2-1.8b", "yi-6b") for m in (64, 24)] + [
    (24, "rwkv6-1.6b"), (24, "zamba2-7b")])
def test_engines_serve_the_same_greedy_tokens(arch, max_len):
    """At max_len 24 the lockstep pooled length passes the buffer: both
    caches then take their writes on the last row (JAX's clamp), and the
    calls that do are compared like every other; the decode steps before
    it run below the buffer.  rwkv6 pools a recurrent state only (it
    ignores the length); zamba2 pools its Mamba states and its shared
    blocks' K/V caches, each merged into the slot's row by the engine's
    batch-axis search."""
    requests = _requests(256)
    rreqs, treqs, rlog, tlog, teng = _serve_both(arch, max_len, requests)
    written_at = _same_greedy_tokens(rreqs, treqs, rlog, tlog)
    assert len(written_at) == teng.stats["decode_steps"]
    clamped = sum(at >= max_len for at in written_at)
    if max_len == 24:
        assert teng.stats["peak_len"] > max_len and clamped >= 3
    else:
        assert clamped == 0
    assert teng.stats["prefills"] == len(requests)
    assert teng.stats["prefill_tokens"] == sum(len(p) for p, _ in requests)


def test_the_engine_starts_from_a_carried_reference_cache():
    """One decode step of both models from the reference's own prefilled
    pool state (``interop.decode_state``): the same logits."""
    rm, rparams, tm, tparams = _models("internlm2-1.8b")
    toks = np.random.default_rng(1).integers(3, 255, (3, 7)).astype(np.int32)
    rlog, rstate = rm.prefill(rparams, {"tokens": jax.numpy.asarray(toks)},
                              16)
    state = interop.decode_state(rstate, tm.cfg, device=CPU)
    nxt = np.argmax(np.asarray(rlog), -1).astype(np.int32)
    rdec, _ = rm.decode_step(rparams, jax.numpy.asarray(nxt), rstate)
    tdec, tstate = tm.decode_step(tparams, torch.from_numpy(nxt), state)
    r = np.asarray(rdec)
    assert np.abs(tdec.numpy() - r).max() <= 1e-5 * np.abs(r).max()
    assert tstate["len"] == 8


@pytest.mark.parametrize("package", ["reference", "port"])
def test_lockstep_length_makes_a_request_depend_on_its_neighbour(package):
    """A reference fault kept bit for bit: slots decode from one pooled
    length, so a short request admitted beside a longer prompt gets RoPE
    positions past its own length and attends to zero K/V rows in the gap.
    Its logits then differ from the same request served alone."""
    rm, rparams, tm, tparams = _models("internlm2-1.8b")
    r = np.random.default_rng(2)
    short = r.integers(3, 255, 6).tolist()
    long = r.integers(3, 255, 20).tolist()

    def first_decode_logits(prompts):
        if package == "reference":
            eng = RServeEngine(rm, rparams, REngineConfig(n_slots=2,
                                                          max_len=48))
        else:
            eng = ServeEngine(tm, tparams, EngineConfig(n_slots=2,
                                                        max_len=48))
        log = []
        _record(eng, log)
        reqs = [eng.submit(p, 4, 0.0) for p in prompts]
        eng.step()
        slot = len(prompts) - 1              # the short request's slot
        return log[-1][0][slot, -1], reqs

    alone, _ = first_decode_logits([short])
    beside, _ = first_decode_logits([long, short])
    assert np.abs(alone - beside).max() > 1e-2 * np.abs(alone).max()


def test_stop_rules():
    _, _, tm, tparams = _models("yi-6b")
    eng = ServeEngine(tm, tparams, EngineConfig(n_slots=2, max_len=12))
    long = eng.submit(list(range(3, 11)), max_new_tokens=50)
    short = eng.submit([5, 6, 7], max_new_tokens=2)
    eng.run()
    assert long.done and short.done
    assert len(short.out_tokens) == 2
    # the slot stops once its own length reaches max_len - 1
    assert len(long.out_tokens) == 12 - 1 - 8 + 1
    eos = EngineConfig(n_slots=1, max_len=32, eos_id=long.out_tokens[0])
    eng = ServeEngine(tm, tparams, eos)
    req = eng.submit(list(range(3, 11)), max_new_tokens=50)
    eng.run()
    # as in the reference, EOS is checked on decoded tokens only: a first
    # (prefill) token equal to it does not end the request
    assert req.out_tokens[-1] == eos.eos_id
    assert eos.eos_id not in req.out_tokens[1:-1] and len(req.out_tokens) > 1


# -------------------------------------------------------------- sampling
def test_sampling_greedy_takes_the_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert sample(logits, 0.0).tolist() == [1, 0]
    assert sample(logits, [0.0, 0.0]).tolist() == [1, 0]


def test_sampling_is_seeded_and_respects_top_k():
    logits = torch.randn(64, 50, generator=torch.Generator().manual_seed(0))
    draw = lambda seed, **kw: sample(
        logits, 0.8, torch.Generator().manual_seed(seed), **kw)
    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))
    top = torch.topk(logits, 3, dim=-1).indices
    for seed in range(5):
        got = draw(seed, top_k=3)
        assert bool((top == got[:, None]).any(-1).all())
    # per-row temperatures: greedy rows stay greedy
    mixed = sample(logits, [0.0, 0.8] * 32, torch.Generator().manual_seed(3))
    assert torch.equal(mixed[0::2], logits[0::2].argmax(-1))


def test_engine_is_deterministic_at_temperature():
    _, _, tm, tparams = _models("yi-6b")

    def run(seed):
        eng = ServeEngine(tm, tparams, EngineConfig(n_slots=3, max_len=40),
                          generator=torch.Generator().manual_seed(seed))
        reqs = [eng.submit(p, n, 0.8) for p, n in _requests(256, 6)]
        eng.run()
        return [r.out_tokens for r in reqs]

    assert run(0) == run(0)


# ---------------------------------------------------- launcher, example
def test_launcher_serves_tokens_on_the_cpu(capsys):
    assert tlaunch.main(["--workload", "tokens", "--smoke", "--device",
                         "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] internlm2-smoke on cpu: 12/12 finished" in out


def test_launcher_serving_scale_knobs():
    out = tlaunch.run(["--workload", "tokens", "--smoke", "--device", "cpu",
                       "--requests", "8", "--slots", "3", "--max-len", "48",
                       "--max-new", "6"])
    assert out["done"] == 8 and out["tokens"] == 8 * 6
    assert [r.temperature for r in out["reqs"]] == [0.8] * 8
    # the reference launcher's prompts: 8 + i % 8 tokens
    assert [len(r.tokens) for r in out["reqs"]] == [8 + i for i in range(8)]
    assert out["engine"].ecfg.n_slots == 3
    assert out["peak_len"] == out["engine"].stats["peak_len"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_launcher_serves_the_recurrent_families(arch):
    """``--arch rwkv6-1.6b`` and ``zamba2-7b`` through the launcher: every
    request finished, every token produced, the pool's state (rwkv6's
    recurrent state; zamba2's Mamba states and shared K/V) on the device."""
    out = tlaunch.run(["--workload", "tokens", "--arch", arch, "--smoke",
                       "--device", "cpu", "--requests", "6", "--max-new",
                       "5"])
    assert out["done"] == 6 and out["tokens"] == 6 * 5
    state = out["engine"].state
    keys = {"rwkv6-1.6b": {"layers", "len"},
            "zamba2-7b": {"blocks", "tail", "shared_kv", "len"}}[arch]
    assert set(state) == keys
    assert state["len"] == out["peak_len"]


def test_launcher_refuses_audio_prompts():
    """The token engine takes token prompts; whisper's prefill needs frames
    too (the reference engine cannot take them either)."""
    with pytest.raises(ValueError, match="token prompts"):
        tlaunch.run(["--workload", "tokens", "--arch", "whisper-base",
                     "--smoke", "--device", "cpu"])


def test_batched_serving_example_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_batched.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert "10/10 requests finished" in res.stdout
