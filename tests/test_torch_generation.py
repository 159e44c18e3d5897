"""The port's generation lane (`mxnet_tpu_torch.serving.generation` and the
KV-cache methods of `TransformerLM`) held to the JAX package's on the CPU.

The model is `test_generation.py`'s tiny one: vocab 64, d_model 32, 2
heads, d_ff 64, 2 layers, max_len 48, from the JAX `init_params(PRNGKey(0))`
carried over by `params_from_jax`. Tolerances:
- fp32 logits rtol 1e-3, atol 1e-4: the JAX suite's own bound for the cache
  path (`test_generation.py:109,121`); slab rows 1e-5, since each is one
  projection of the same inputs, a few ulp apart;
- bf16 logits and slab allclose with atol = rtol = 2e-2: both sides round
  every product and LayerNorm output to bf16, at places that differ, so
  values agree to about one bf16 ulp of their size (2^-8 relative);
- greedy tokens and token streams exactly: argmax breaks ties at the first
  index in both packages, and no logit gap here comes near the fp32 error.
On the CPU the engine's programs run eagerly (no CUDA graphs); the graph
path is checked on the card by `chip_smoke.py`'s generate phase.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import parallel as par
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu_torch import compile_cache
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving import (DeadlineExceededError, QueueFullError,
                                     ServerClosedError, warmup)
from mxnet_tpu_torch.serving.generation import (GenerationEngine,
                                                prefill_ladder)

VOCAB = 64
SMALL = dict(vocab_size=VOCAB, d_model=32, n_heads=2, d_ff=64, n_layers=2,
             max_len=48)
TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SLAB_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _jax_model(dtype="float32", **over):
    cfg = dict(SMALL, dtype=dtype, **over)
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    jlm = JaxLM(JaxConfig(**cfg), mesh)
    return jlm, jlm.init_params(jax.random.PRNGKey(0)), cfg


def _port_model(jparams, cfg):
    tlm = TransformerLM(TransformerLMConfig(**cfg), device="cpu")
    tlm.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu"))
    return tlm


@pytest.fixture(scope="module")
def models():
    """The tiny fp32 model on both sides, shared (parameters are only
    read)."""
    jlm, jparams, cfg = _jax_model()
    return jlm, jparams, _port_model(jparams, cfg)


@pytest.fixture
def lm(models):
    return models[2]


def _prompts(n, lo=2, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _np(t):
    return t.detach().float().numpy()


def _assert_same_greedy(got, want, what):
    """Equal argmax per row; on a difference, the top-2 logit gap of the
    reference at the first row that differs (a near-tie if below the
    fp32 tolerance)."""
    a, b = got.argmax(-1), want.argmax(-1)
    if not np.array_equal(a, b):
        row = int(np.flatnonzero(a.reshape(-1) != b.reshape(-1))[0])
        top = np.sort(want.reshape(-1, want.shape[-1])[row])[-2:]
        pytest.fail(f"{what}: greedy token differs at row {row} "
                    f"({a.reshape(-1)[row]} vs {b.reshape(-1)[row]}); "
                    f"reference top-2 gap {top[1] - top[0]}")


# ---------------------------------------------------------------------------
# the model's KV-cache methods
# ---------------------------------------------------------------------------


def test_init_cache_shape_and_bound(lm):
    ck, cv = lm.init_cache(3, 32)
    for t in (ck, cv):
        assert t.shape == (3, 2, 2, 32, 16)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert not t.any()
    assert ck.data_ptr() != cv.data_ptr()
    assert lm.init_cache(2)[0].shape[3] == SMALL["max_len"]
    with pytest.raises(ValueError):
        lm.init_cache(2, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """A padded 6-token prompt in bucket 8 prefilled into slot 1 of a
    3-slot slab, then 4 decode steps with slots 0 and 2 dead at the safe
    row (the slab's last): logits, greedy tokens and slab contents match
    the JAX methods."""
    jlm, jparams, cfg = _jax_model(dtype)
    tlm = _port_model(jparams, cfg)
    tol, slab_tol = TOL[dtype], SLAB_TOL[dtype]
    rng = np.random.RandomState(3)
    toks = np.zeros(8, np.int32)
    toks[:6] = rng.randint(1, VOCAB, 6)
    jck, jcv = jlm.init_cache(3, 32)
    jlogits, jck, jcv = jax.jit(jlm.prefill)(
        jparams, jck, jcv, jnp.asarray(toks), jnp.asarray(6),
        jnp.asarray(1))
    ck, cv = tlm.init_cache(3, 32)
    logits, ck2, cv2 = tlm.prefill(ck, cv, torch.from_numpy(toks).long(),
                                   torch.tensor([6]), torch.tensor([1]))
    assert ck2 is ck and cv2 is cv          # written in place
    assert logits.shape == (VOCAB,) and logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **tol)
    _assert_same_greedy(_np(logits), np.asarray(jlogits), "prefill")
    for got, want in ((ck, jck), (cv, jcv)):
        np.testing.assert_allclose(_np(got[1, :, :, :6]),
                                   np.asarray(want[1, :, :, :6], np.float32),
                                   **slab_tol)
        assert not got[[0, 2]].any()        # other slots untouched

    dec = jax.jit(jlm.decode_step)
    tokens = np.zeros(3, np.int32)
    positions = np.full(3, 31, np.int32)    # dead slots: the safe row
    cur, pos = int(np.argmax(np.asarray(jlogits))), 6
    for step in range(4):
        tokens[1], positions[1] = cur, pos
        jl, jck, jcv = dec(jparams, jck, jcv, jnp.asarray(tokens),
                           jnp.asarray(positions))
        tl, _, _ = tlm.decode_step(ck, cv, torch.from_numpy(tokens).long(),
                                   torch.from_numpy(positions).long())
        want = np.asarray(jl)
        assert tl.shape == (3, VOCAB) and bool(torch.isfinite(tl).all())
        np.testing.assert_allclose(_np(tl), want, **tol,
                                   err_msg=f"step {step}")
        _assert_same_greedy(_np(tl), want, f"decode step {step}")
        cur, pos = int(np.argmax(want[1])), pos + 1
    for got, want in ((ck, jck), (cv, jcv)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **slab_tol)


def test_prefill_accepts_int_operands(lm):
    """Eager callers may pass Python ints for slot and length; the engine
    passes device tensors. Both write the same rows."""
    toks = torch.tensor([5, 9, 3, 0])
    ck, cv = lm.init_cache(2, 16)
    a, _, _ = lm.prefill(ck, cv, toks, 3, 1)
    ck2, cv2 = lm.init_cache(2, 16)
    b, _, _ = lm.prefill(ck2, cv2, toks, torch.tensor([3]),
                         torch.tensor([1]))
    assert torch.equal(a, b) and torch.equal(ck, ck2) and torch.equal(cv, cv2)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


def test_engine_greedy_streams_match_jax(models):
    """12 ragged prompts through the JAX engine and the port's (3 slots,
    buckets (8, 16), the same weights): identical greedy token lists."""
    jlm, jparams, tlm = models
    prompts = _prompts(12, seed=12)
    news = [3 + (i % 6) for i in range(len(prompts))]
    with JaxEngine(jlm, jparams, max_slots=3, max_len=48,
                   buckets=(8, 16)) as jeng:
        want = [s.result(timeout=120) for s in
                [jeng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, news)]]
    with GenerationEngine(tlm, max_slots=3, max_len=48,
                          buckets=(8, 16)) as eng:
        got = [s.result(timeout=60) for s in
               [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, news)]]
    assert got == want


def test_engine_loads_params_dict(models):
    """A state dict in the port's names is loaded into the model first."""
    jlm, jparams, _ = models
    cfg = dict(SMALL, dtype="float32")
    fresh = TransformerLM(TransformerLMConfig(**cfg), device="cpu",
                          generator=torch.Generator().manual_seed(7))
    state = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                            device="cpu")
    eng = GenerationEngine(fresh, state, max_slots=1, max_len=48,
                           buckets=(16,), start=False)
    assert torch.equal(fresh.embed, state["embed"])
    eng.close()


# ---------------------------------------------------------------------------
# the engine: parity, isolation, scheduling (test_generation.py:137-360)
# ---------------------------------------------------------------------------


def test_continuous_matches_sequential(lm):
    """24 ragged sessions through a 3-slot engine (forced queueing and
    mid-stream admit/evict) give BIT-EXACT token streams against each
    session run alone through an engine of the same slab shape."""
    prompts = _prompts(24, seed=1)
    with GenerationEngine(lm, max_slots=3, max_len=48,
                          buckets=(8, 16)) as eng:
        streams = [eng.submit(p, max_new_tokens=3 + (i % 5))
                   for i, p in enumerate(prompts)]
        got = [s.result(timeout=60) for s in streams]
    with GenerationEngine(lm, max_slots=3, max_len=48,
                          buckets=(8, 16)) as ref:
        for i, p in enumerate(prompts):
            alone = ref.generate(p, max_new_tokens=3 + (i % 5))
            assert alone == got[i], f"session {i} diverged under batching"


def test_slot_reuse_isolation(lm):
    """No KV bleed: with ONE slot, session B decoded after session A
    dirtied the slot equals B run in a fresh engine."""
    a, b = _prompts(2, seed=2)
    with GenerationEngine(lm, max_slots=1, max_len=48,
                          buckets=(16,)) as eng:
        eng.generate(a, max_new_tokens=10)
        b_after = eng.generate(b, max_new_tokens=8)
    with GenerationEngine(lm, max_slots=1, max_len=48,
                          buckets=(16,)) as fresh:
        assert fresh.generate(b, max_new_tokens=8) == b_after


def test_eos_eviction(lm):
    """A session whose greedy stream hits eos_id stops there (the EOS token
    is delivered) and frees its slot."""
    (p,) = _prompts(1, seed=5)
    with GenerationEngine(lm, max_slots=2, max_len=48,
                          buckets=(16,)) as eng:
        full = eng.generate(p, max_new_tokens=10)
        # eos must be a token at its FIRST occurrence in the stream
        k = max(i for i, t in enumerate(full) if t not in full[:i])
        short = eng.generate(p, max_new_tokens=10, eos_id=full[k])
        assert eng.live_slots == 0
    assert short == full[:k + 1]


def test_submit_validation(lm):
    with GenerationEngine(lm, max_slots=1, max_len=48,
                          buckets=(8,)) as eng:
        with pytest.raises(MXNetError):
            eng.submit(np.zeros(0, np.int32))           # empty
        with pytest.raises(MXNetError):
            eng.submit(np.ones(9, np.int32))            # > largest bucket
        with pytest.raises(MXNetError):
            eng.submit([1, 2], max_new_tokens=47)       # 2 + 47 > 48
        with pytest.raises(MXNetError):
            eng.submit([1, 2], max_new_tokens=0)
        for bad in ([1, VOCAB], [-1, 2]):               # outside the vocab
            with pytest.raises(MXNetError):
                eng.submit(bad)
    assert prefill_ladder(None, 48) == (8, 16, 32, 48)
    assert prefill_ladder((64, 4), 48) == (4, 48)
    assert prefill_ladder("16, 8", 48) == (8, 16)
    with pytest.raises(MXNetError):
        prefill_ladder("8,x", 48)


def test_positions_stay_in_the_slab(lm):
    """The card faults where JAX clamps, so the host keeps every index in
    range: a live slot writes at its length, a dead one at the last row,
    and a length past the slab raises before anything runs."""
    eng = GenerationEngine(lm, max_slots=3, max_len=20, buckets=(8,),
                           start=False)
    s = eng.submit([1, 2, 3], max_new_tokens=4)
    # admit into slot 0 and decode once (the overlap order admits after
    # the tick's decode, so that takes two ticks there, one in lockstep)
    while len(s.tokens) < 2:
        eng._tick_once()
    assert eng.live_slots == 1
    assert list(eng._tick_positions()) == [4, 19, 19]
    eng._lengths[0] = 20
    with pytest.raises(MXNetError):
        eng._tick_positions()
    eng._lengths[0] = 4
    while not s.done:
        eng._tick_once()
    assert len(s.result(timeout=5)) == 4
    eng.close()


def test_max_len_evicts_at_slab_capacity(lm):
    """A session that fills its slot's rows ends there with the tokens it
    has; every decode position stayed below the slab's length."""
    eng = GenerationEngine(lm, max_slots=1, max_len=12, buckets=(8,),
                           start=False)
    s = eng.submit(list(range(1, 9)), max_new_tokens=4)
    seen = []
    real = eng._tick_positions

    def spy():
        pos = real()
        seen.append(int(pos.max()))
        return pos

    eng._tick_positions = spy
    while not s.done:
        eng._tick_once()
    assert len(s.result(timeout=5)) == 4
    assert max(seen) <= 11 and eng.live_slots == 0
    eng.close()


# ---------------------------------------------------------------------------
# warmup / build discipline
# ---------------------------------------------------------------------------


def test_warmup_build_pinning(lm):
    """Exactly len(buckets) prefill builds + ONE decode build; a second
    warmup builds nothing; concurrent ragged traffic afterwards builds
    nothing more, and one decode program serves every pattern."""
    eng = GenerationEngine(lm, max_slots=4, max_len=48, buckets=(8, 16, 32))
    w = warmup(eng)
    assert w["compiles"] == 4                      # 3 prefill + 1 decode
    assert w["captures"] == 0                      # no graphs on the CPU
    assert warmup(eng)["compiles"] == 0
    before = compile_cache.named_stats("generation")
    streams = [eng.submit(p, max_new_tokens=4 + (i % 6))
               for i, p in enumerate(_prompts(16, lo=2, hi=30, seed=6))]
    for s in streams:
        s.result(timeout=60)
    after = compile_cache.named_stats("generation")
    assert after["misses"] - before["misses"] == 0, \
        "steady-state generation traffic built something"
    assert after["hits"] > before["hits"]
    assert [k for k in eng.cache.keys() if k[0] == "decode"] == [
        ("decode", 4, 48)]
    assert len(eng.cache) == 4
    eng.close()
    with pytest.raises(TypeError):
        warmup(lm)


# ---------------------------------------------------------------------------
# deadlines / backpressure / drain / failure
# ---------------------------------------------------------------------------


def test_deadline_while_queued(lm):
    """A session expiring in the queue fails with DeadlineExceededError at
    the next tick sweep; it never wedges behind the session holding the
    only slot."""
    with GenerationEngine(lm, max_slots=1, max_len=48,
                          buckets=(16,)) as eng:
        a = eng.submit(_prompts(1, seed=7)[0], max_new_tokens=40)
        b = eng.submit(_prompts(1, seed=8)[0], max_new_tokens=5,
                       timeout=0.001)
        with pytest.raises(DeadlineExceededError):
            b.result(timeout=60)
        with pytest.raises(DeadlineExceededError):
            list(b)
        assert len(a.result(timeout=60)) == 40     # survivor unaffected


def test_deadline_mid_generation():
    """A LIVE session past its deadline is evicted at the tick sweep: the
    stream raises after the tokens already delivered, and the slot frees."""
    jlm, jparams, cfg = _jax_model(max_len=256, n_layers=1, d_model=16)
    lm = _port_model(jparams, cfg)
    with GenerationEngine(lm, max_slots=1, max_len=256,
                          buckets=(8,)) as eng:
        s = eng.submit([1, 2, 3], max_new_tokens=250, timeout=0.05)
        with pytest.raises(DeadlineExceededError):
            for _ in s:
                pass
        assert 1 <= len(s.tokens) < 250            # partial stream
        deadline = time.monotonic() + 5
        while eng.live_slots and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.live_slots == 0


def test_queue_full_and_manual_drain(lm):
    """QueueFullError the moment the bound is hit (no worker: start=False,
    ticks driven by hand), then close() and ServerClosedError for new
    work."""
    eng = GenerationEngine(lm, max_slots=1, max_len=48, buckets=(8,),
                           max_queue=2, start=False)
    a = eng.submit([1, 2], max_new_tokens=2)
    b = eng.submit([3, 4], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        eng.submit([5, 6], max_new_tokens=2)
    assert eng.queue_depth == 2
    for _ in range(16):
        eng._tick_once()
        if a.done and b.done:
            break
    assert len(a.result(timeout=5)) == 2
    assert len(b.result(timeout=5)) == 2
    eng.close()
    with pytest.raises(ServerClosedError):
        eng.submit([7], max_new_tokens=1)


def test_close_drains(lm):
    """close() completes every admitted AND queued session before
    returning."""
    eng = GenerationEngine(lm, max_slots=2, max_len=48, buckets=(16,))
    streams = [eng.submit(p, max_new_tokens=6) for p in _prompts(5, seed=9)]
    eng.close()
    for s in streams:
        assert len(s.result(timeout=1)) == 6
    assert not eng._worker.is_alive()


def test_prefill_failure_never_strands(lm):
    """A prefill failure fails the popped session's stream in band (it is
    in neither the queue nor a slot when the forward raises), the slab is
    zeroed IN PLACE (the graphs keep its pointers) and the engine keeps
    serving afterwards."""
    eng = GenerationEngine(lm, max_slots=2, max_len=48, buckets=(8,),
                           start=False)
    eng.warm()
    ptr = eng._ck.data_ptr()

    class Boom(RuntimeError):
        pass

    def bad_prefill(bucket):
        def fn(*a, **k):
            raise Boom("device error")
        return fn

    eng._prefill_fn = bad_prefill
    s = eng.submit([1, 2, 3], max_new_tokens=4)
    eng._tick_once()
    with pytest.raises(Boom):
        s.result(timeout=1)
    with pytest.raises(Boom):
        list(s)
    assert eng._ck.data_ptr() == ptr and not eng._ck.any()
    assert not eng._cv.any() and eng.live_slots == 0
    del eng.__dict__["_prefill_fn"]               # heal
    s2 = eng.submit([4, 5], max_new_tokens=3)
    for _ in range(8):
        eng._tick_once()
        if s2.done:
            break
    assert len(s2.result(timeout=5)) == 3
    assert eng.cache.misses == 2                  # nothing rebuilt
    eng.close()


def test_decode_failure_fails_live_sessions(lm):
    """A decode failure fails every live session in band; queued ones are
    admitted afterwards on the zeroed slab. The tick budget is set beyond
    reach so the first tick admits both sessions however slow the host."""
    eng = GenerationEngine(lm, max_slots=2, max_len=48, buckets=(8,),
                           tick_budget_ms=60_000, start=False)
    live = [eng.submit([1, 2], max_new_tokens=5) for _ in range(2)]
    queued = eng.submit([3, 4], max_new_tokens=2)
    eng._tick_once()                    # both live, the third queued
    assert eng.live_slots == 2 and eng.queue_depth == 1
    real = eng._decode_fn
    eng._decode_fn = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    eng._tick_once()
    assert eng.live_slots == 0 and eng.queue_depth == 1
    for s in live:
        with pytest.raises(RuntimeError, match="boom"):
            s.result(timeout=1)
    eng._decode_fn = real
    while not queued.done:
        eng._tick_once()
    assert len(queued.result(timeout=5)) == 2
    eng.close()


def test_concurrent_submitters(lm):
    """Many client threads submit and iterate (each iterator assisting the
    worker) at once: every stream completes with its own tokens, equal to
    the same prompt run alone."""
    prompts = _prompts(16, seed=13)
    results = [None] * len(prompts)
    with GenerationEngine(lm, max_slots=3, max_len=48,
                          buckets=(8, 16)) as eng:
        def client(i):
            results[i] = list(eng.submit(prompts[i], max_new_tokens=5))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        for i in (0, 7, 15):
            assert eng.generate(prompts[i], max_new_tokens=5) == results[i]
