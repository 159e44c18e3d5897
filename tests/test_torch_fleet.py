"""The port's fleet-wide rolling weight swap on the CPU, held to the JAX
package's `tests/python/unittest/test_rollout.py:424-500`
(`test_rolling_swap_flips_fleet`, `..._burn_gate_rollback`,
`test_swap_races_scale_to`), plus a roll under live traffic whose streams
are held to the JAX engine's on each version.

The fleet is replicas over ONE model, as in the JAX tests (each engine
serves its own set). The model is `test_rollout.py`'s (vocab 64, d_model
32, 2 heads, d_ff 64, 2 layers, max_len 48, fp32) with the two weight
versions `init_params(PRNGKey(0))` and `PRNGKey(1)`, carried over by
`params_from_jax`. Reports, versions, journal events and counters must
equal the JAX router's; streams must equal the JAX engine's (``==``).
"""
import threading
import time

import numpy as np
import pytest

import jax

from mxnet_tpu import health as jhealth
from mxnet_tpu import parallel as par
from mxnet_tpu import telemetry as jtele
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving import rollout as jrollout
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu.serving.generation import GenerationRouter as JaxRouter
from mxnet_tpu_torch import health, telemetry
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving import rollout
from mxnet_tpu_torch.serving.generation import (GenerationEngine,
                                                GenerationRouter)

VOCAB = 64


@pytest.fixture(scope="module")
def lm2():
    """(JAX model, its two weight versions, the port's model, the two
    versions in the port's names)."""
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    cfg = dict(vocab_size=VOCAB, d_model=32, n_heads=2, d_ff=64, n_layers=2,
               max_len=48, dtype="float32")
    jlm = JaxLM(JaxConfig(**cfg), mesh)
    jp0 = jlm.init_params(jax.random.PRNGKey(0))
    jp1 = jlm.init_params(jax.random.PRNGKey(1))
    lm = TransformerLM(TransformerLMConfig(**cfg), device="cpu")
    p0, p1 = (params_from_jax({k: np.asarray(v) for k, v in p.items()},
                              device="cpu") for p in (jp0, jp1))
    lm.load_state_dict(p0)
    return jlm, jp0, jp1, lm, p0, p1


@pytest.fixture
def healthy():
    """Telemetry and health on in both packages, reset before and after."""
    prev = (telemetry.enabled(), jtele.enabled(), health.enabled(),
            jhealth.enabled())
    for mod in (telemetry, jtele, health, jhealth):
        mod.enable()
    health.reset()
    jhealth.reset()
    yield
    health.reset()
    jhealth.reset()
    for mod, was in zip((telemetry, jtele, health, jhealth), prev):
        mod.enable(was)


def _counter(name, mod=telemetry):
    c = mod.get(name)
    return c.value if c is not None else 0


def _fleet(lm2, pkg, n=3, factory_seed=0):
    """A router over ``n`` 4-slot replicas of one model, of package
    ``pkg`` (0: JAX, 1: the port), each on version-0 weights; the factory
    builds on the ``factory_seed`` set."""
    jlm, jp0, jp1, lm, p0, p1 = lm2
    if pkg == 0:
        fp = (jp0, jp1)[factory_seed]
        engines = [JaxEngine(jlm, jp0, max_slots=4, max_len=48)
                   for _ in range(n)]
        return JaxRouter(engines, factory=lambda: JaxEngine(
            jlm, fp, max_slots=4, max_len=48))
    fp = (p0, p1)[factory_seed]
    engines = [GenerationEngine(lm, p0, max_slots=4, max_len=48)
               for _ in range(n)]
    return GenerationRouter(engines, factory=lambda: GenerationEngine(
        lm, fp, max_slots=4, max_len=48))


def _ws(lm2, pkg, version, seed):
    """A WeightSet of package ``pkg`` holding the ``seed`` weights."""
    jlm, jp0, jp1, lm, p0, p1 = lm2
    if pkg == 0:
        return jrollout.WeightSet(version, (jp0, jp1)[seed], source="test")
    return rollout.WeightSet(version, {k: v.numpy() for k, v in
                                       (p0, p1)[seed].items()},
                             source="test")


def _events(mod, kind):
    return [e for e in mod.events() if e["kind"] == kind]


def test_rolling_swap_flips_fleet(healthy, lm2, monkeypatch):
    """Both replicas flip, one ``rollout_roll`` event each; a second
    publish of the same version no-ops on every replica. Same reports as
    the JAX router's."""
    monkeypatch.setenv("MXNET_SLO_SPEC", "rollout_quiet.probe:value<=1")
    reports = []
    for pkg, mod in ((1, health), (0, jhealth)):
        mod.reset()
        router = _fleet(lm2, pkg, n=2)
        try:
            ws = _ws(lm2, pkg, 5, 1)
            rep = router.rolling_swap(ws, observe_s=0)
            assert [e.weights_version for e in router.engines] == [5, 5]
            assert len(_events(mod, "rollout_roll")) == 2
            rep2 = router.rolling_swap(ws, observe_s=0)
            reports.append((rep, rep2))
        finally:
            router.close()
    (rep, rep2), (jrep, jrep2) = reports
    assert rep == jrep and rep2 == jrep2
    assert rep["swapped"] == 2 and not rep["rolled_back"]
    assert rep2["swapped"] == 0 and rep2["noops"] == 2


def test_rolling_swap_burn_gate_rollback(healthy, lm2, monkeypatch):
    """A burn above the gate after a flip rolls every flipped replica back
    to the pinned previous version, journaled; a roll of a rollback
    converges on the same version. Same reports and counts as JAX."""
    monkeypatch.setenv("MXNET_SLO_SPEC", "rollout_probe.errors:value<=0")
    monkeypatch.setenv("MXNET_SLO_GRACE_S", "0")
    out = []
    for pkg, hmod, tmod in ((1, health, telemetry), (0, jhealth, jtele)):
        hmod.reset()                   # the tracker rebuilt from the spec
        router = _fleet(lm2, pkg, n=2)
        try:
            first = router.rolling_swap(_ws(lm2, pkg, 5, 1), observe_s=0)
            tmod.gauge("rollout_probe.errors").set(1)      # a breach
            before = _counter("rollout.rollbacks", tmod)
            rep = router.rolling_swap(_ws(lm2, pkg, 6, 0), observe_s=0)
            versions = [e.weights_version for e in router.engines]
            rollbacks = _counter("rollout.rollbacks", tmod) - before
            restored = _events(hmod, "rollout_rollback")[-1]["restored"]
            rep2 = router.rolling_swap(_ws(lm2, pkg, 7, 0), observe_s=0)
            versions2 = [e.weights_version for e in router.engines]
            out.append((first["swapped"], rep, versions, rollbacks,
                        restored, rep2, versions2))
        finally:
            router.close()
            tmod.gauge("rollout_probe.errors").set(0)
    assert out[0] == out[1]
    swapped, rep, versions, rollbacks, restored, rep2, versions2 = out[0]
    assert swapped == 2 and rep["rolled_back"] and rep["burn"] > 1.0
    assert versions == [5, 5] and rollbacks == 1 and restored == 5
    assert rep2["rolled_back"] and versions2 == [5, 5]


def test_swap_races_scale_to(healthy, lm2, monkeypatch):
    """`rolling_swap` and `scale_to` serialize on the scale lock; a replica
    grown after a roll joins on the fleet's version, not the factory's
    construction weights; a shrink after still works."""
    monkeypatch.setenv("MXNET_SLO_SPEC", "rollout_quiet.probe:value<=1")
    for pkg, mod in ((1, health), (0, jhealth)):
        mod.reset()
        router = _fleet(lm2, pkg, n=2)
        try:
            ws = _ws(lm2, pkg, 3, 1)
            errs = []

            def roll():
                try:
                    router.rolling_swap(ws, observe_s=0)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            t = threading.Thread(target=roll)
            t.start()
            router.scale_to(3, warm=False)       # a concurrent grow
            t.join()
            assert not errs
            assert [e.weights_version for e in router.engines] == [3, 3, 3]
            router.scale_to(2, warm=False)
            assert all(e.weights_version == 3 for e in router.engines)
        finally:
            router.close()


def _prompts(n, lo=2, hi=10, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def test_rolling_swap_under_traffic_keeps_each_version(healthy, lm2,
                                                       monkeypatch):
    """Sessions admitted before a roll finish on the old weights, those
    after it on the new, nothing is built by the roll, and every stream
    equals the JAX engine's stream on its version."""
    monkeypatch.setenv("MXNET_SLO_SPEC", "rollout_quiet.probe:value<=1")
    jlm, jp0, jp1, lm, p0, p1 = lm2
    prompts = _prompts(8, seed=5)
    router = _fleet(lm2, 1, n=2)
    try:
        router.warm()
        misses = [e.cache.misses for e in router.engines]
        old = [router.submit(p, max_new_tokens=30) for p in prompts[:4]]
        for s in old:               # admitted (version pinned) before it
            for _ in range(2000):
                if s.tokens:
                    break
                time.sleep(0.005)
        rep = router.rolling_swap(_ws(lm2, 1, 9, 1), observe_s=0)
        new = [router.submit(p, max_new_tokens=30) for p in prompts[4:]]
        got = [s.result(timeout=60) for s in old + new]
        assert rep["swapped"] == 2
        assert [s.weights_version for s in old] == [0] * 4
        assert [s.weights_version for s in new] == [9] * 4
        assert [e.cache.misses for e in router.engines] == misses
    finally:
        router.close()
    want = []
    for params, batch in ((jp0, prompts[:4]), (jp1, prompts[4:])):
        with JaxEngine(jlm, params, max_slots=4, max_len=48) as eng:
            want += [eng.generate(p, max_new_tokens=30) for p in batch]
    assert got == want


def test_rolling_swap_no_longer_raises(lm2):
    """The parent port raised NotImplementedError from `rolling_swap`; a
    roll of a one-replica fleet with the health layer off now flips it."""
    router = _fleet(lm2, 1, n=1)
    try:
        rep = router.rolling_swap(_ws(lm2, 1, 2, 1), observe_s=0)
        assert rep["swapped"] == 1 and rep["burn"] is None
        assert router.engines[0].weights_version == 2
    finally:
        router.close()
