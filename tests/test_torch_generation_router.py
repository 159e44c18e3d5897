"""The port's `GenerationRouter` and the engine's health probes on the
CPU, mirroring `tests/python/unittest/test_generation.py:381-420` and
`test_generation_scale.py:606-687` (without the autoscale signal, not
ported yet).

The model is `test_generation.py`'s `lm48` (vocab 64, d_model 32, 2
heads, d_ff 64, 2 layers, max_len 48, fp32, `init_params(PRNGKey(0))`),
carried over by `params_from_jax`; its engines share the model. Routed
streams are held bit for bit (``==``) to the JAX router's over the same
fleet shape, whose placement is the same rule.
"""
import numpy as np
import pytest

import jax

from mxnet_tpu import parallel as par
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu.serving.generation import GenerationRouter as JaxRouter
from mxnet_tpu_torch import health
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving import QueueFullError, warmup
from mxnet_tpu_torch.serving.generation import (GenerationEngine,
                                                GenerationRouter)

VOCAB = 64


@pytest.fixture(scope="module")
def lm48():
    """(JAX model, its params, the port's model with the same weights)."""
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    cfg = dict(vocab_size=VOCAB, d_model=32, n_heads=2, d_ff=64, n_layers=2,
               max_len=48, dtype="float32")
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


def _prefix_engine(lm, **kw):
    return GenerationEngine(lm, max_slots=4, max_len=48, buckets=(8, 16),
                            prefix_cache=True, prefix_min_tokens=4, **kw)


def test_router_balance_matches_jax(lm48):
    """24 submissions to an idle 3-replica fleet spread evenly (rotating
    tie-break), all complete, and give the JAX router's streams."""
    jlm, jparams, lm = lm48
    prompts = _prompts(24, seed=11)
    engines = [GenerationEngine(lm, max_slots=4, max_len=48, buckets=(16,))
               for _ in range(3)]
    with GenerationRouter(engines) as router:
        assert warmup(router)["compiles"] == 3 * 2
        assert router.loads() == [0.0, 0.0, 0.0]
        streams = [router.submit(p, max_new_tokens=5) for p in prompts]
        got = [s.result(timeout=60) for s in streams]
        counts = [e.sessions_submitted for e in engines]
        assert router.stats()["replicas"] == 3
    assert sum(counts) == 24 and all(4 <= c <= 12 for c in counts), counts
    jengines = [JaxEngine(jlm, jparams, max_slots=4, max_len=48,
                          buckets=(16,)) for _ in range(3)]
    with JaxRouter(jengines) as jrouter:
        want = [jrouter.generate(p, max_new_tokens=5) for p in prompts]
    assert got == want


def test_router_failover_when_full(lm48):
    """A saturated replica is skipped; only a fully saturated fleet
    raises `QueueFullError`, and a closed replica fails over too."""
    _, _, lm = lm48
    kw = dict(max_slots=1, max_len=48, buckets=(8,), max_queue=1,
              start=False)
    e1, e2 = GenerationEngine(lm, **kw), GenerationEngine(lm, **kw)
    router = GenerationRouter([e1, e2])
    streams = [router.submit([1, 2], max_new_tokens=2) for _ in range(2)]
    assert [e.queue_depth for e in (e1, e2)] == [1, 1]
    with pytest.raises(QueueFullError):
        router.submit([1, 2], max_new_tokens=2)
    for eng in (e1, e2):
        for _ in range(8):
            eng._tick_once()
    for s in streams:
        assert len(s.result(timeout=5)) == 2
    e1.close()
    s = router.submit([3, 4], max_new_tokens=2)     # e1 closed: e2 takes it
    assert e2.queue_depth == 1
    for _ in range(4):
        e2._tick_once()
    assert len(s.result(timeout=5)) == 2
    router.close()


def test_router_prefix_affinity(lm48, journal):
    """Placement follows the cache: the engine holding the longest prompt
    prefix wins even when it is busier, the choice is journaled, and a
    prompt no cache holds goes by load."""
    _, _, lm = lm48
    e0, e1 = _prefix_engine(lm), _prefix_engine(lm)
    rng = np.random.RandomState(14)
    sysp = rng.randint(1, VOCAB, 8).astype(np.int32)
    with GenerationRouter([e0, e1]) as router:
        e1.generate(np.concatenate(
            [sysp, rng.randint(1, VOCAB, 2).astype(np.int32)]),
            max_new_tokens=2)
        assert e1.prefix_match_len(np.concatenate([sysp, [1]])) == 8
        assert e0.prefix_match_len(np.concatenate([sysp, [1]])) == 0
        busy = e1.submit(rng.randint(1, VOCAB, 5).astype(np.int32),
                         max_new_tokens=24)
        assert e1.load > e0.load
        s = router.submit(np.concatenate(
            [sysp, rng.randint(1, VOCAB, 3).astype(np.int32)]),
            max_new_tokens=2)
        s.result(timeout=30)
        assert s.cached_prefix_len == 8, \
            "affinity did not route to the cache-holding engine"
        ev = journal.events(kind="router_affinity")[-1]
        assert ev["matched"] == 8 and ev["engine"] == e1.health_name
        busy.result(timeout=60)
        s2 = router.submit(rng.randint(33, VOCAB, 4).astype(np.int32),
                           max_new_tokens=2)
        s2.result(timeout=30)
        assert s2.cached_prefix_len == 0
        assert len(journal.events(kind="router_affinity")) == 1


def test_router_scale_to(lm48, journal):
    """`scale_to` grows from the factory (each new replica warmed before
    it takes traffic) and drains surplus replicas with no session lost;
    it clamps to the bounds, needs a factory to grow, and a closed router
    does not scale."""
    _, _, lm = lm48

    def factory():
        return _prefix_engine(lm)

    with pytest.raises(MXNetError):
        GenerationRouter([])
    router = GenerationRouter([factory()], factory=factory, max_engines=3)
    assert router.scale_to(5) == 3 and len(router.engines) == 3
    assert all(len(e.cache) > 0 for e in router.engines[1:])
    streams = [router.submit(p, max_new_tokens=4)
               for p in _prompts(9, seed=16)]
    assert router.scale_to(0) == 1 and len(router.engines) == 1
    for s in streams:
        assert len(s.result(timeout=60)) == 4
    ev = journal.events(kind="autoscale_actuate")
    assert [(e["grown"], e["drained"]) for e in ev] == [(2, 0), (0, 2)]
    router.close()
    assert router.scale_to(3) == 1 and len(router.engines) == 1
    with pytest.raises(MXNetError):
        GenerationRouter([factory()]).scale_to(2)


def test_router_waits_for_later_items(lm48):
    """QoS rebalancing and the burn-gated rolling swap are ported (A.2): a
    one-replica fleet has no peer to migrate to, and a roll with no
    weights raises the swap's own error; the autoscale hook (A.1) returns
    the callback it registered, which resizes the fleet."""
    from mxnet_tpu_torch import health

    _, _, lm = lm48
    router = GenerationRouter([GenerationEngine(lm, max_slots=1, max_len=48,
                                                buckets=(8,), start=False)])
    assert router.rebalance_parked() == 0
    with pytest.raises(MXNetError):
        router.rolling_swap({})
    cb = router.bind_autoscale()
    try:
        assert cb in health._autoscale_cbs
        cb(1, {})                      # already one replica: no change
        assert len(router.engines) == 1
    finally:
        health._autoscale_cbs.remove(cb)
    router.close()


def test_engine_probes_and_readiness_drain(lm48, journal):
    """`attach_engine`'s probes: an engine is ready once warmed (or once
    traffic built a program), not while closed; the router drains an
    unready replica and places on the ready one, journaling both
    transitions."""
    _, _, lm = lm48
    kw = dict(max_slots=2, max_len=48, buckets=(8,), start=False)
    cold, warm = GenerationEngine(lm, **kw), GenerationEngine(lm, **kw)
    warm.warm()
    assert cold.ready() == (False, "warmup not run")
    assert warm.ready()[0] and warm.healthy() == (True, "ok")
    ok, probes = health.readiness()
    assert not ok and not probes[cold.health_name]["ok"]
    assert probes[warm.health_name]["ok"]
    router = GenerationRouter([cold, warm])
    for _ in range(3):
        router.submit([1, 2, 3], max_new_tokens=1)
    assert (cold.queue_depth, warm.queue_depth) == (0, 3)
    ev = journal.events(kind="engine_drain")
    assert [e["engine"] for e in ev] == [cold.health_name]
    cold.warm()
    router.submit([1, 2, 3], max_new_tokens=1)
    assert journal.events(kind="engine_undrain")[-1]["engine"] == \
        cold.health_name
    warm.close()
    assert warm.ready() == (False, "closed (draining)")
    assert warm.health_name not in health.readiness()[1]
    router.close()
