"""The port's prefix-cache lane (`TransformerLM.prefill_at`,
`serving.generation.prefix_cache` and the engine's fork admission) held
to the JAX package on the CPU, mirroring
`tests/python/unittest/test_generation_scale.py:110-154` and `:298-652`.

The model is that suite's `lm64` (vocab 64, d_model 32, 2 heads, d_ff 64,
2 layers, max_len 64, fp32, `init_params(PRNGKey(0))`), carried over by
`params_from_jax`. Tolerances: `prefill_at` logits at rtol 1e-3 / atol
1e-4 with equal argmax, the JAX suite's bound for fork + suffix against
the full prefill (`test_generation_scale.py:110`); the JAX suite has no
counterpart of the port's hit and miss counters (its telemetry is not
ported), so they are held to the trie's own behaviour; streams exactly.
The MoE guard of the JAX engine (`test_moe_disables_prefix_cache`) has no
counterpart: the port's `TransformerLM` refuses MoE configs.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from mxnet_tpu import parallel as par
from mxnet_tpu.base import getenv as jax_getenv
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu.serving.generation import RadixPrefixCache as JaxCache
from mxnet_tpu_torch import compile_cache, health
from mxnet_tpu_torch.base import getenv
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving import QueueFullError, warmup
from mxnet_tpu_torch.serving.generation import (GenerationEngine,
                                                NgramDraft,
                                                RadixPrefixCache)

VOCAB = 64
TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def lm64():
    """(JAX model, its params, the port's model with the same weights)."""
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    cfg = dict(vocab_size=VOCAB, d_model=32, n_heads=2, d_ff=64, n_layers=2,
               max_len=64, dtype="float32")
    jlm = JaxLM(JaxConfig(**cfg), mesh)
    jparams = jlm.init_params(jax.random.PRNGKey(0))
    lm = TransformerLM(TransformerLMConfig(**cfg), device="cpu")
    lm.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu"))
    return jlm, jparams, lm


@pytest.fixture
def journal():
    was = health.enabled()
    health.reset()
    health.enable()
    yield health
    health.reset()
    health.enable(was)


def _prompts(n, lo=2, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _engine(lm, **kw):
    args = dict(max_slots=4, max_len=48, buckets=(8, 16), prefix_cache=True,
                prefix_min_tokens=4)
    args.update(kw)
    return GenerationEngine(lm, **args)


def _tick_until(eng, stream, ticks=64):
    for _ in range(ticks):
        eng._tick_once()
        if stream.done:
            break
    return stream.result(timeout=10)


# ---------------------------------------------------------------------------
# the model's suffix prefill
# ---------------------------------------------------------------------------


def test_prefill_at_matches_jax_and_full_prefill(lm64):
    """Prefill of a prefix, fork to another slot, suffix prefill: the
    logits match the JAX package's `prefill_at` on the same slab and the
    port's full prefill of the whole prompt, with equal argmax, at three
    split points; the suffix's rows land at [split, split + 8)."""
    jlm, jparams, lm = lm64
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, VOCAB, 12)
    full = np.zeros(16, np.int64)
    full[:12] = prompt
    ck, cv = lm.init_cache(3, 32)
    ref = lm.prefill(ck, cv, torch.from_numpy(full), 12, 1)[0].numpy()
    jpf, jpfa = jax.jit(jlm.prefill), jax.jit(jlm.prefill_at)
    for split in (4, 8, 11):
        pre = np.zeros(16, np.int64)
        pre[:split] = prompt[:split]
        ns = 12 - split
        sfx = np.zeros(8, np.int64)
        sfx[:ns] = prompt[split:]
        ck, cv = lm.init_cache(3, 32)
        lm.prefill(ck, cv, torch.from_numpy(pre), split, 0)
        for t in (ck, cv):
            t.index_copy_(0, torch.tensor([2]), t.index_select(
                0, torch.tensor([0])))
        logits, ck2, _ = lm.prefill_at(
            ck, cv, torch.from_numpy(sfx), torch.tensor([ns]),
            torch.tensor([2]), torch.tensor([split]))
        assert ck2 is ck and logits.shape == (VOCAB,)
        got = logits.numpy()
        np.testing.assert_allclose(got, ref, **TOL, err_msg=f"{split}")
        assert got.argmax() == ref.argmax(), split

        jck, jcv = jlm.init_cache(3, 32)
        _, jck, jcv = jpf(jparams, jck, jcv, jnp.asarray(pre, jnp.int32),
                          jnp.asarray(split), jnp.asarray(0))
        jck = lax.dynamic_update_slice(jck, jck[0:1], (2, 0, 0, 0, 0))
        jcv = lax.dynamic_update_slice(jcv, jcv[0:1], (2, 0, 0, 0, 0))
        want, jck, _ = jpfa(jparams, jck, jcv, jnp.asarray(sfx, jnp.int32),
                            jnp.asarray(ns), jnp.asarray(2),
                            jnp.asarray(split))
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        assert got.argmax() == np.asarray(want).argmax(), split
        np.testing.assert_allclose(
            ck[2, :, :, :split + 8].numpy(),
            np.asarray(jck)[2, :, :, :split + 8], rtol=1e-5, atol=1e-5)


def test_prefill_at_clamps_positions_past_the_range(lm64):
    """A suffix whose padded rows run past the model's positional range
    reads its last positional row there, as JAX's clipping gather does,
    and gives the JAX logits."""
    jlm, jparams, lm = lm64
    sfx = np.zeros(16, np.int64)
    sfx[:3] = [5, 9, 11]
    ck, cv = lm.init_cache(1, 64)
    got = lm.prefill_at(ck, cv, torch.from_numpy(sfx), 3, 0, 48)[0]
    jck, jcv = jlm.init_cache(1, 64)
    want, _, _ = jax.jit(jlm.prefill_at)(
        jparams, jck, jcv, jnp.asarray(sfx, jnp.int32), jnp.asarray(3),
        jnp.asarray(0), jnp.asarray(48))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the radix trie against the JAX package's
# ---------------------------------------------------------------------------


def test_radix_cache_matches_jax():
    """One sequence of inserts, matches, pins and evictions on the port's
    trie and the JAX package's: the same matches, entries, evictions and
    stats at every step (the trie is host code, copied whole)."""
    caches = (RadixPrefixCache(), JaxCache())
    sysp = list(range(1, 11))
    ops = [("insert", sysp + [20, 21], 0, 0), ("insert", sysp + [30], 1, 0),
           ("insert", sysp[:6], 2, 0), ("insert", sysp + [20, 21], 3, 0),
           ("match", sysp + [20, 21], None), ("match", sysp + [30, 31], 0),
           ("match", sysp[:3], 0), ("match", [40, 41], 0),
           ("match", sysp + [20, 21, 22], 1), ("acquire", sysp + [20, 21]),
           ("evict_lru",), ("evict_lru",), ("release", sysp + [20, 21]),
           ("insert", sysp + [30], 4, 1), ("evict_other_versions", 1),
           ("insert", [7, 7, 7, 7], 5, 1), ("evict_slot", 5),
           ("evict_slot", 9), ("insert", sysp, 6, 1), ("evict_lru",),
           ("evict_lru",)]
    held = {}
    for op in ops:
        outs = []
        for c in caches:
            if op[0] == "insert":
                out = c.insert(np.asarray(op[1]), op[2], version=op[3])
                out = None if out is None else (out.length, out.slot)
            elif op[0] == "match":
                node, m = c.match(np.asarray(op[1]), version=op[2])
                out = (None if node is None else node.slot, m)
            elif op[0] in ("acquire", "release"):
                node, _ = c.match(np.asarray(op[1]))
                held.setdefault(id(c), node)
                getattr(c, op[0])(held[id(c)])
                out = held[id(c)].refs
            else:
                out = getattr(c, op[0])(*op[1:])
            outs.append((out, c.entries(), c.stats(), len(c),
                         c.cached_tokens()))
            time.sleep(0.001)          # distinct LRU clocks
        assert outs[0] == outs[1], op


# ---------------------------------------------------------------------------
# the engine's prefix lane
# ---------------------------------------------------------------------------


def test_prefix_streams_and_hits_match_jax(lm64):
    """Sessions sharing a system prompt, one at a time, through the
    port's and the JAX package's engines with the cache on: the same
    streams, every hit forked at the same length, and the streams of a
    plain engine."""
    jlm, jparams, lm = lm64
    rng = np.random.RandomState(8)
    sysp = rng.randint(1, VOCAB, 10).astype(np.int32)
    prompts = [np.concatenate([sysp, rng.randint(1, VOCAB, 1 + i % 4)
                               .astype(np.int32)]) for i in range(6)]
    kw = dict(max_slots=4, max_len=48, buckets=(8, 16), prefix_cache=True,
              prefix_min_tokens=4)
    with GenerationEngine(lm, **kw) as eng:
        streams = [eng.submit(p, max_new_tokens=4) for p in prompts[:1]]
        streams[0].result(timeout=30)
        streams += [eng.submit(p, max_new_tokens=4) for p in prompts[1:]]
        got = [s.result(timeout=30) for s in streams]
        forked = [s.cached_prefix_len for s in streams]
        assert eng.prefix_hits >= 5 and eng.prefix_misses >= 1
        assert eng.prefix_hits + eng.prefix_misses == len(prompts)
    with JaxEngine(jlm, jparams, **kw) as jeng:
        jstreams = [jeng.submit(prompts[0], max_new_tokens=4)]
        jstreams[0].result(timeout=120)
        jstreams += [jeng.submit(p, max_new_tokens=4) for p in prompts[1:]]
        want = [s.result(timeout=120) for s in jstreams]
        assert forked == [s.cached_prefix_len for s in jstreams]
    assert got == want and forked[0] == 0 and min(forked[1:]) >= 10
    with GenerationEngine(lm, max_slots=4, max_len=48,
                          buckets=(8, 16)) as plain:
        assert [plain.generate(p, max_new_tokens=4) for p in prompts] == got


def test_fork_hit_path_and_counts(lm64):
    """A cache-hit admission runs the fork and suffix programs (exactly 2
    cache hits, no build) instead of the full prefill, counts one hit and
    stamps the stream's cached_prefix_len."""
    _, _, lm = lm64
    rng = np.random.RandomState(8)
    sysp = rng.randint(1, VOCAB, 10).astype(np.int32)
    eng = _engine(lm, start=False)
    eng.warm()
    p1 = np.concatenate([sysp, rng.randint(1, VOCAB, 3).astype(np.int32)])
    s1 = eng.submit(p1, max_new_tokens=1)      # miss: full prefill + insert
    eng._tick_once()
    assert s1.result(timeout=10) and s1.cached_prefix_len == 0
    assert (eng.prefix_hits, eng.prefix_misses) == (0, 1)
    assert len(eng.prefix_cache) == 1
    # the same prompt again matches its own entry at len - 1, and the
    # insert dedupes: the admission runs exactly fork + suffix prefill
    before = compile_cache.named_stats("generation")
    s2 = eng.submit(p1, max_new_tokens=1)
    eng._tick_once()
    assert s2.result(timeout=10) == s1.result()
    after = compile_cache.named_stats("generation")
    assert after["misses"] == before["misses"]
    assert after["hits"] - before["hits"] == 2, \
        "the hit admission did not run the fork + suffix pair"
    assert s2.cached_prefix_len == len(p1) - 1
    assert (eng.prefix_hits, eng.prefix_misses) == (1, 1)
    assert eng.stats()["prefix"]["entries"] == 1
    eng.close()


def test_fork_isolation_after_source_evicts(lm64):
    """The fork is a copy: a session forked from an entry whose source is
    evicted mid-generation finishes with the stream it has when the source
    survives, which is the plain engine's."""
    _, _, lm = lm64
    rng = np.random.RandomState(10)
    sysp = rng.randint(1, VOCAB, 9).astype(np.int32)
    seed_p = np.concatenate([sysp, rng.randint(1, VOCAB, 2).astype(np.int32)])
    hit_p = np.concatenate([sysp, rng.randint(1, VOCAB, 3).astype(np.int32)])

    def run(evict_mid):
        eng = _engine(lm, max_slots=3, buckets=(16,), start=False)
        _tick_until(eng, eng.submit(seed_p, max_new_tokens=2))
        assert len(eng.prefix_cache) >= 1
        s = eng.submit(hit_p, max_new_tokens=8)
        eng._tick_once()                       # fork-admit + first tokens
        assert s.cached_prefix_len >= 9
        if evict_mid:
            for slot in list(eng.prefix_cache.slots()):
                assert eng.prefix_cache.evict_slot(slot)
            assert len(eng.prefix_cache) == 0
        out = _tick_until(eng, s)
        eng.close()
        return out

    evicted = run(evict_mid=True)
    assert evicted == run(evict_mid=False)
    with GenerationEngine(lm, max_slots=3, max_len=48,
                          buckets=(16,)) as plain:
        assert plain.generate(hit_p, max_new_tokens=8) == evicted


@pytest.mark.parametrize("spec_k", [0, 3])
def test_cached_rows_survive_ticks(lm64, spec_k):
    """A cached entry's K/V rows are bit-identical after many decode (and
    verify) ticks of another session: every tick writes rows of every
    slot, cache-held ones included, and those writes must land on the
    safe rows no entry owns."""
    _, _, lm = lm64
    rng = np.random.RandomState(19)
    seed_p = rng.randint(1, VOCAB, 10).astype(np.int32)
    eng = _engine(lm, max_slots=3, max_len=32, buckets=(16,), spec_k=spec_k,
                  draft=NgramDraft() if spec_k else None, start=False)
    # one token: the seed session ends inside its admission tick, so the
    # snapshot below is taken before any decode tick
    _tick_until(eng, eng.submit(seed_p, max_new_tokens=1))
    (cslot,) = eng.prefix_cache.slots()
    n = len(seed_p)
    before = [t[cslot, :, :, :n].clone() for t in (eng._ck, eng._cv)]
    _tick_until(eng, eng.submit(rng.randint(1, VOCAB, 4).astype(np.int32),
                                max_new_tokens=12))
    for t, b in zip((eng._ck, eng._cv), before):
        assert torch.equal(t[cslot, :, :, :n], b), \
            f"spec_k={spec_k}: cached rows written by tick writes"
    eng.close()


def test_fork_falls_back_when_suffix_bucket_overhangs(lm64):
    """A prompt whose suffix BUCKET would overhang the slab's edge takes
    the full prefill instead (a miss) and gives the plain stream."""
    _, _, lm = lm64
    rng = np.random.RandomState(20)
    seed_p = rng.randint(1, VOCAB, 12).astype(np.int32)
    # 15 tokens sharing 12: suffix 3 -> bucket 8, 12 + 8 = 20 > 16
    hit_p = np.concatenate([seed_p, rng.randint(1, VOCAB, 3)
                            .astype(np.int32)])
    eng = _engine(lm, max_slots=3, max_len=16, start=False)
    _tick_until(eng, eng.submit(seed_p, max_new_tokens=1))
    assert len(eng.prefix_cache) == 1
    misses = eng.prefix_misses
    s = eng.submit(hit_p, max_new_tokens=1)
    out = _tick_until(eng, s)
    assert s.cached_prefix_len == 0, "the overhanging fork was not refused"
    assert eng.prefix_misses - misses == 1 and eng.prefix_hits == 0
    eng.close()
    with GenerationEngine(lm, max_slots=3, max_len=16,
                          buckets=(8, 16)) as plain:
        assert plain.generate(hit_p, max_new_tokens=1) == out


@pytest.mark.parametrize("overlap", ["0", "1"], ids=["lockstep", "overlap"])
def test_pressure_eviction_spares_the_heads_prefix(lm64, monkeypatch,
                                                   overlap):
    """A session needing a slot when only cached prefixes hold them
    evicts an entry it does not share: the entry the queue's head would
    fork from stays pinned while the victim is picked, so the head hits.
    Four slots, one tick: P (system prompt + tail) and Q (unrelated)
    admit and cache themselves; R (system prompt + another tail) then
    evicts Q's newer entry, not P's older one, and forks P's rows,
    giving the plain engine's stream."""
    monkeypatch.setenv("MXNET_OVERLAP", overlap)
    _, _, lm = lm64
    rng = np.random.RandomState(21)
    sysp = rng.randint(1, VOCAB, 8).astype(np.int32)
    p = np.concatenate([sysp, rng.randint(1, VOCAB, 2).astype(np.int32)])
    q = rng.randint(1, VOCAB, 7).astype(np.int32)
    while q[0] == sysp[0]:
        q[0] = (q[0] % (VOCAB - 1)) + 1
    r = np.concatenate([sysp, rng.randint(1, VOCAB, 3).astype(np.int32)])
    # one tick admits all three, however slow the host
    eng = _engine(lm, start=False, tick_budget_ms=60_000)
    sp, sq, sr = (eng.submit(x, max_new_tokens=6) for x in (p, q, r))
    eng._tick_once()
    assert sp.cached_prefix_len == sq.cached_prefix_len == 0
    assert sr.cached_prefix_len == len(sysp), "the head's prefix was evicted"
    assert (eng.prefix_hits, eng.prefix_misses) == (1, 2)
    # P's entry, in the slot after P's own
    assert eng.prefix_cache.entries() == [(len(p), 1, 0)]
    out = _tick_until(eng, sr)
    eng.close()
    with GenerationEngine(lm, max_slots=4, max_len=48,
                          buckets=(8, 16)) as plain:
        assert plain.generate(r, max_new_tokens=6) == out


@pytest.mark.parametrize("overlap", ["0", "1"], ids=["lockstep", "overlap"])
def test_refcount_safe_eviction_under_churn(lm64, journal, monkeypatch,
                                            overlap):
    """40 sessions (half sharing a prefix) from 4 threads through a
    4-slot slab with the cache competing for slots: every session
    completes, pressure evicts, refcounts return to zero, no cached slot
    is a live one, and the retained hot prefix keeps hitting. In both
    tick orders (``MXNET_OVERLAP``); the overlap order is the JAX suite's
    default, where eviction and admission run while a decode is in
    flight."""
    monkeypatch.setenv("MXNET_OVERLAP", overlap)
    _, _, lm = lm64
    rng = np.random.RandomState(11)
    sysp = rng.randint(1, VOCAB, 8).astype(np.int32)
    prompts = []
    for i in range(40):
        tail = rng.randint(1, VOCAB, 1 + (i % 4)).astype(np.int32)
        prompts.append(np.concatenate([sysp, tail]) if i % 2 == 0
                       else rng.randint(1, VOCAB, 6 + (i % 5))
                       .astype(np.int32))
    eng = _engine(lm)
    errors, streams = [], [None] * 40

    def submitter(lo, hi):
        try:
            for i in range(lo, hi):
                while True:
                    try:
                        streams[i] = eng.submit(prompts[i],
                                                max_new_tokens=2 + (i % 4))
                        break
                    except QueueFullError:
                        time.sleep(0.002)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(k * 10, (k + 1) * 10))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    for i, s in enumerate(streams):
        assert len(s.result(timeout=60)) == 2 + (i % 4)
    held = eng.prefix_cache.slots()
    assert all(eng._sessions[i] is None for i in held)
    assert all(r == 0 for (_, _, r) in eng.prefix_cache.entries())
    assert journal.events(kind="prefix_evict"), \
        "churn never forced an eviction"
    assert eng.prefix_hits > 0
    eng.close()


def test_prefix_eviction_journaled(lm64, journal):
    """Evictions land in the health journal (``prefix_evict``) with their
    reason, the engine as owner, the slot and the tokens."""
    _, _, lm = lm64
    eng = _engine(lm, max_slots=2, buckets=(8,), prefix_min_tokens=2,
                  start=False)
    _tick_until(eng, eng.submit(_prompts(1, seed=12, lo=4, hi=6)[0],
                                max_new_tokens=1))
    assert len(eng.prefix_cache) == 1
    (slot,) = eng.prefix_cache.slots()
    assert eng.prefix_cache.evict_lru("test_pressure") == slot
    ev = journal.events(kind="prefix_evict")[-1]
    assert ev["reason"] == "test_pressure" and ev["slot"] == slot
    assert ev["engine"] == eng.health_name and ev["tokens"] >= 4
    eng.close()


def test_compile_accounting_both_features(lm64):
    """warm() with the prefix cache and the speculative lane (n-gram)
    builds exactly 2 * len(buckets) + 2 programs (prefill and suffix a
    bucket, THE fork, THE verify); mixed concurrent traffic afterwards
    builds nothing, with one fork key, one verify key and no decode."""
    _, _, lm = lm64
    rng = np.random.RandomState(13)
    sysp = rng.randint(1, VOCAB, 9).astype(np.int32)
    eng = _engine(lm, buckets=(8, 16, 32), spec_k=4, draft=NgramDraft())
    w = warmup(eng)
    assert w["compiles"] == 2 * 3 + 2 and w["captures"] == 0
    assert warmup(eng)["compiles"] == 0
    before = compile_cache.named_stats("generation")
    prompts = [np.concatenate([sysp, rng.randint(1, VOCAB, 1 + (i % 6))
                               .astype(np.int32)])
               if i % 2 else
               rng.randint(1, VOCAB, 2 + (i % 20)).astype(np.int32)
               for i in range(24)]
    streams = [eng.submit(p, max_new_tokens=3 + (i % 6))
               for i, p in enumerate(prompts)]
    for s in streams:
        s.result(timeout=60)
    assert compile_cache.named_stats("generation")["misses"] == \
        before["misses"], "steady-state traffic built a program"
    keys = eng.cache.keys()
    assert [k[0] for k in keys].count("fork") == 1
    assert [k[0] for k in keys].count("verify") == 1
    assert not [k for k in keys if k[0] == "decode"]
    assert eng.prefix_hits > 0 and eng.spec_verified_slots > 0
    eng.close()


def test_defaults_off(lm64):
    """Without the knobs or the arguments an engine is the plain lane: no
    prefix cache, no speculative lane, one prefill a bucket and one
    decode. The knobs carry the JAX package's defaults."""
    _, _, lm = lm64
    for name in ("MXNET_GENERATION_PREFIX_CACHE",
                 "MXNET_GENERATION_PREFIX_MIN_TOKENS"):
        assert getenv(name) == jax_getenv(name)
    eng = GenerationEngine(lm, max_slots=2, max_len=48, buckets=(8,),
                           start=False)
    assert eng.prefix_cache is None and eng.draft is None
    assert eng.spec_k == 0 and eng.prefix_match_len([1, 2, 3]) == 0
    assert eng.warm()["compiles"] == 2
    eng.close()


def test_prefix_cache_from_env(lm64, monkeypatch):
    """``MXNET_GENERATION_PREFIX_CACHE=1`` turns the lane on;
    ``_PREFIX_MIN_TOKENS`` sets the threshold `prefix_match_len` and
    admission use."""
    _, _, lm = lm64
    monkeypatch.setenv("MXNET_GENERATION_PREFIX_CACHE", "1")
    monkeypatch.setenv("MXNET_GENERATION_PREFIX_MIN_TOKENS", "6")
    eng = GenerationEngine(lm, max_slots=3, max_len=48, buckets=(16,),
                           start=False)
    assert eng.prefix_cache is not None
    p = np.arange(1, 11, dtype=np.int32)
    _tick_until(eng, eng.submit(p, max_new_tokens=1))
    assert eng.prefix_match_len(p) == 9
    assert eng.prefix_match_len(p[:5]) == 0          # 4 < 6
    eng.close()
