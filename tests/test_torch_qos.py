"""The port's multi-tenant QoS lane on the CPU, held to the JAX package's
`tests/python/unittest/test_qos.py` case by case: the spec grammar and
registry (quotas, aging), the class-ordered admission queue, QoS off
changing nothing, preemption into the park region with a bit-exact
resume, the parked deadline sweep, the weighted demand, class placement
and parked migration in the router, a three-tenant mix, and the labeled
telemetry (Prometheus text, the report line, the per-tenant SLO rows).

Registry decisions and queue orders are compared with the JAX package's
under the same fixed clock; counters and Prometheus text must be equal.
Engine cases run the same scenario on both packages over `test_qos.py`'s
`lm48` model (vocab 64, d_model 32, 2 heads, d_ff 64, 2 layers, max_len
48, fp32, `init_params(PRNGKey(0))`, carried over by `params_from_jax`):
every token stream must equal the JAX engine's (``==``).
"""
import json
import time
from concurrent.futures import Future

import numpy as np
import pytest

import jax

from mxnet_tpu import health as jhealth
from mxnet_tpu import parallel as par
from mxnet_tpu import telemetry as jtele
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving import qos as jqos
from mxnet_tpu.serving.admission import AdmissionQueue as JaxQueue
from mxnet_tpu.serving.admission import Request as JaxRequest
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu.serving.generation import GenerationRouter as JaxRouter
from mxnet_tpu_torch import health, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving import (DeadlineExceededError,
                                     QuotaExceededError, qos)
from mxnet_tpu_torch.serving.admission import AdmissionQueue, Request
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
def tele():
    prev, jprev = telemetry.enabled(), jtele.enabled()
    telemetry.enable()
    jtele.enable()
    yield telemetry
    telemetry.enable(prev)
    jtele.enable(jprev)


@pytest.fixture(autouse=True)
def _qos_clean():
    """Each test leaves both packages' registries cleared."""
    yield
    qos.clear()
    jqos.clear()


def _counter(name, mod=telemetry):
    m = mod.get(name)
    return m.value if m is not None else 0


def _reg(spec, **kw):
    """Install the same registry in both packages."""
    jqos.install(jqos.TenantRegistry(jqos.parse_spec(spec), **kw))
    return qos.install(qos.TenantRegistry(qos.parse_spec(spec), **kw))


def _prompts(n, lo=2, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _drive(eng, streams, max_ticks=600):
    """Tick a start=False engine by hand until every stream resolved."""
    for _ in range(max_ticks):
        if all(s._future.done() for s in streams):
            return
        eng._tick_once()
    raise AssertionError("sessions did not complete within the tick budget")


def _engine(lm48, pkg, **kw):
    """An engine of package ``pkg`` (0: JAX, 1: the port)."""
    jlm, jparams, lm = lm48
    return (JaxEngine(jlm, jparams, **kw) if pkg == 0
            else GenerationEngine(lm, **kw))


def _engines(lm48, **kw):
    """A JAX engine and a port engine of the same shape."""
    return _engine(lm48, 0, **kw), _engine(lm48, 1, **kw)


def _reqs(cls, specs):
    """Requests of one package from (tenant, deadline) pairs."""
    return [cls([np.zeros((1, 1), np.float32)], 1, Future(), deadline=d,
                tenant=t) for t, d in specs]


# -- spec grammar / registry -------------------------------------------------


def test_parse_spec_matches_jax():
    text = ("acme:interactive:rps=10,tps=500,weight=3;"
            "api:standard; bulk:batch:tps=100")
    t, jt = qos.parse_spec(text), jqos.parse_spec(text)
    assert set(t) == set(jt) == {"acme", "api", "bulk"}
    for name in t:
        assert ((t[name].cls, t[name].rank, t[name].rps, t[name].tps,
                 t[name].weight)
                == (jt[name].cls, jt[name].rank, jt[name].rps, jt[name].tps,
                    jt[name].weight))
    assert (t["acme"].rank, t["acme"].rps, t["acme"].tps,
            t["acme"].weight) == (0, 10.0, 500.0, 3.0)
    assert (t["bulk"].rank, t["bulk"].weight) == (2, 0.25)
    assert qos.parse_spec("") == {} and qos.parse_spec("  ;; ") == {}


def test_parse_spec_rejects_what_jax_rejects():
    for bad in ("acme", "acme:gold", ":interactive", "a:batch:rps=fast",
                "a:batch:burst=9", "a:interactive;a:batch",
                "a:interactive:rps=0"):
        with pytest.raises(MXNetError):
            qos.parse_spec(bad)
        with pytest.raises(Exception):
            jqos.parse_spec(bad)
    with pytest.raises(MXNetError):
        qos.TenantRegistry({}, default_class="gold")


def test_registry_defaults_and_aging_match_jax():
    reg = qos.TenantRegistry(qos.parse_spec("bulk:batch"),
                             default_class="interactive", aging_s=30.0)
    jreg = jqos.TenantRegistry(jqos.parse_spec("bulk:batch"),
                               default_class="interactive", aging_s=30.0)
    for r in (reg, jreg):
        assert r.rank("stranger") == 0 and r.rank(None) == 0
        assert r.spec_for(None).name == "default"
        assert r.weight("stranger") == 2.0 and r.weight("bulk") == 0.25
        r.check_admit("stranger")          # no quota, never raises
    now = 1000.0
    for age in (31.0, 1.0, 500.0):
        for rank in (0, 1, 2):
            assert (reg.effective_rank(rank, now - age, now)
                    == jreg.effective_rank(rank, now - age, now))
    assert reg.effective_rank(qos.BATCH_RANK, now - 31.0, now) == 1
    assert reg.effective_rank(qos.BATCH_RANK, now - 1.0, now) == 2
    frozen = qos.TenantRegistry({}, aging_s=0.0)
    assert frozen.effective_rank(qos.BATCH_RANK, now - 500.0, now) == 2


def _quota_trace(mod, spec, steps):
    """Admit/charge decisions of one package's registry under a fixed
    clock: True (admitted) or False (QuotaExceededError)."""
    reg = mod.TenantRegistry(mod.parse_spec(spec))
    t0 = time.monotonic()
    out = []
    for op, tenant, dt, n in steps:
        if op == "charge":
            reg.charge_tokens(tenant, n, now=t0 + dt)
            continue
        try:
            reg.check_admit(tenant, now=t0 + dt)
            out.append(True)
        except mod.QuotaExceededError:
            out.append(False)
    return out


@pytest.mark.parametrize("spec,steps,want", [
    ("acme:interactive:rps=2",
     [("admit", "acme", 0.0, 0), ("admit", "acme", 0.0, 0),
      ("admit", "acme", 0.0, 0), ("admit", "acme", 0.6, 0)],
     [True, True, False, True]),
    ("bulk:batch:tps=10",
     [("admit", "bulk", 0.0, 0), ("charge", "bulk", 0.0, 25),
      ("admit", "bulk", 0.0, 0), ("admit", "bulk", 2.0, 0)],
     [True, False, True]),
], ids=["request_rate", "token_rate"])
def test_quota_buckets_match_jax(spec, steps, want):
    assert _quota_trace(qos, spec, steps) == want
    assert _quota_trace(jqos, spec, steps) == want


def test_active_lifecycle(monkeypatch):
    qos.clear()
    monkeypatch.setenv("MXNET_QOS_SPEC", "acme:interactive")
    assert qos.active().rank("acme") == 0
    monkeypatch.setenv("MXNET_QOS_SPEC", "acme:batch")
    assert qos.active().rank("acme") == 0    # resolved once, not re-read
    qos.clear()
    assert qos.active().rank("acme") == 2    # clear() re-reads
    qos.install(None)                        # programmatic OFF beats env
    assert qos.active() is None
    qos.clear()
    monkeypatch.delenv("MXNET_QOS_SPEC")
    assert qos.active() is None


# -- the admission queue -----------------------------------------------------


def _pop_order(queue_cls, req_cls, specs, prefix, sleep_between=0.0):
    q = queue_cls(8, metric_prefix=prefix)
    reqs = []
    for spec in specs:
        r = _reqs(req_cls, [spec])[0]
        q.put(r)
        reqs.append(r)
        if sleep_between:
            time.sleep(sleep_between)
    peek = q.peek()
    popped = q._pop(len(reqs))
    return [reqs.index(r) for r in popped], reqs.index(peek), reqs


def test_queue_fifo_when_off():
    qos.install(None)
    jqos.install(None)
    d = time.monotonic() + 0.1
    specs = [("bulk", None), (None, d), ("acme", None)]
    order, _, reqs = _pop_order(AdmissionQueue, Request, specs, "t_off")
    jorder, _, _ = _pop_order(JaxQueue, JaxRequest, specs, "t_off")
    assert order == jorder == [0, 1, 2]             # strict arrival order
    assert all(r.qos_rank is None for r in reqs)    # nothing stamped
    assert AdmissionQueue(8, metric_prefix="t_off2").weighted_depth() == 0


def test_queue_priority_and_deadline_order_matches_jax():
    _reg("lat:interactive;api:standard;bulk:batch")
    now = time.monotonic()
    specs = [("bulk", None), ("api", None), ("lat", now + 60),
             ("lat", now + 1)]
    order, peek, _ = _pop_order(AdmissionQueue, Request, specs, "t_prio")
    jorder, jpeek, _ = _pop_order(JaxQueue, JaxRequest, specs, "t_prio")
    # class rank first; within a class the earliest deadline, though later
    assert order == jorder == [3, 2, 1, 0]
    assert peek == jpeek == 3


def test_queue_aging_promotion_matches_jax():
    _reg("bulk:batch", aging_s=0.05)
    specs = [("bulk", None), (None, None)]     # old batch, fresh standard
    order, _, _ = _pop_order(AdmissionQueue, Request, specs, "t_age",
                             sleep_between=0.06)
    jorder, _, _ = _pop_order(JaxQueue, JaxRequest, specs, "t_age",
                              sleep_between=0.06)
    # the batch request aged into standard rank; FIFO breaks the tie
    assert order == jorder == [0, 1]


def test_quota_reject_counters_match_jax(tele):
    _reg("acme:standard:rps=1")
    got = {}
    for name, mod, queue_cls, req_cls, err in (
            ("port", telemetry, AdmissionQueue, Request, QuotaExceededError),
            ("jax", jtele, JaxQueue, JaxRequest, jqos.QuotaExceededError)):
        q = queue_cls(8, metric_prefix="t_quota")
        rej = mod.labeled("qos.rejected", tenant="acme",
                          **{"class": "standard"})
        adm = mod.labeled("qos.admitted", tenant="acme",
                          **{"class": "standard"})
        before = [_counter(n, mod) for n in (rej, adm, "t_quota.rejected")]
        q.put(_reqs(req_cls, [("acme", None)])[0])
        with pytest.raises(err):
            q.put(_reqs(req_cls, [("acme", None)])[0])
        # a migrated (exempt) request skips the quota entirely
        ex = _reqs(req_cls, [("acme", None)])[0]
        ex.qos_exempt = True
        q.put(ex)
        got[name] = [_counter(n, mod) - b for n, b in
                     zip((rej, adm, "t_quota.rejected"), before)]
    assert got["port"] == got["jax"] == [1, 2, 1]


# -- engine: off changes nothing ---------------------------------------------


def test_engine_off_bit_identity(lm48, tele):
    """QoS off: no park rows and no qos stats; the program keys and the
    build counts are the lane-free engine's; streams equal the JAX
    engine's."""
    qos.install(None)
    jqos.install(None)
    kw = dict(max_slots=2, max_len=48, buckets=(8, 16), start=False)
    jeng, eng = _engines(lm48, **kw)
    try:
        assert eng.total_slots == eng.max_slots == 2
        assert eng.parked_count == 0 and eng.batch_live == 0
        assert eng.qos_demand() is None
        assert "qos" not in eng.stats()
        assert eng.warm()["compiles"] == jeng.warm()["compiles"] == 3
        assert sorted(eng.cache.keys()) == sorted(jeng.cache.keys())
        assert ("decode", 2, 48) in eng.cache.keys()
        m0 = eng.cache.misses
        out = []
        for e in (eng, jeng):
            streams = [e.submit(p, max_new_tokens=3, tenant="ignored")
                       for p in _prompts(4, seed=21)]
            _drive(e, streams)
            out.append([s.result(1) for s in streams])
        assert eng.cache.misses == m0
        assert out[0] == out[1] and all(len(t) == 3 for t in out[0])
    finally:
        eng.close()
        jeng.close()


# -- engine: preemption, parking, bit-exact resume ---------------------------


def _round_trip(eng, bp, ip):
    bs = [eng.submit(p, max_new_tokens=8, tenant="bulk") for p in bp]
    for _ in range(200):
        if eng.live_slots == 2:
            break
        eng._tick_once()
    assert eng.live_slots == 2 and eng.batch_live == 2
    istream = eng.submit(ip, max_new_tokens=4, tenant="lat")
    _drive(eng, bs + [istream])
    return [s.result(1) for s in bs], istream.result(1)


def test_preempt_resume_bit_parity(lm48, tele):
    """Two batch sessions fill a 2-slot slab; an interactive arrival parks
    the youngest through THE fork and takes its slot; the parked one
    resumes and ends bit-exact with an uncontended run on a slab of the
    same shape, and with the JAX engine's streams. A second round builds
    nothing."""
    _reg("lat:interactive;bulk:batch")
    bp = _prompts(2, seed=30)
    (ip,) = _prompts(1, seed=31)
    jbase, base = _engines(lm48, max_slots=2, max_len=48, buckets=(16,))
    with jbase, base:
        want = [base.generate(p, max_new_tokens=8) for p in bp]
        iwant = base.generate(ip, max_new_tokens=4)
        assert want == [jbase.generate(p, max_new_tokens=8) for p in bp]
        assert iwant == jbase.generate(ip, max_new_tokens=4)
    jeng, eng = _engines(lm48, max_slots=2, max_len=48, buckets=(16,),
                         start=False)
    try:
        assert eng.total_slots == 3 and eng.max_slots == 2
        resumed = telemetry.labeled("qos.resumed", tenant="bulk",
                                    **{"class": "batch"})
        pre0, res0 = (_counter("serving.generation.preemptions"),
                      _counter(resumed))
        got, igot = _round_trip(eng, bp, ip)
        jgot, jigot = _round_trip(jeng, bp, ip)
        assert _counter("serving.generation.preemptions") - pre0 == 1
        assert _counter(resumed) - res0 == 1
        assert got == jgot == want, "a preempted stream diverged"
        assert igot == jigot == iwant
        assert eng.parked_count == 0
        assert eng.stats()["qos"] == {"park_slots": 1, "parked": 0,
                                      "weighted_demand": 0.0}
        m0 = eng.cache.misses
        assert _round_trip(eng, bp, ip) == (want, iwant)
        assert eng.cache.misses == m0, "preempt/resume built a program"
    finally:
        eng.close()
        jeng.close()


def test_parked_deadline_sweep(lm48, tele):
    """Parking does not stop a session's clock: a parked batch session
    past its deadline fails at the sweep with DeadlineExceededError and
    frees its park row; the survivor is untouched."""
    _reg("lat:interactive;bulk:batch")
    (bp,), (ip,) = _prompts(1, seed=33), _prompts(1, seed=34)
    eng = _engine(lm48, 1, max_slots=1, max_len=48, buckets=(16,),
                  start=False)
    with GenerationEngine(lm48[2], max_slots=1, max_len=48,
                          buckets=(16,)) as base:
        iwant = base.generate(ip, max_new_tokens=40)
    try:
        b = eng.submit(bp, max_new_tokens=30, tenant="bulk", timeout=60.0)
        for _ in range(100):
            if eng.live_slots == 1:
                break
            eng._tick_once()
        i = eng.submit(ip, max_new_tokens=40, tenant="lat")
        eng._tick_once()                          # preempts b into the park
        assert eng.parked_count == 1
        rec = next(iter(eng._parked.values()))
        rec["sess"].deadline = time.monotonic() - 0.01
        ev0 = _counter("serving.generation.evict_deadline")
        _drive(eng, [b, i])
        with pytest.raises(DeadlineExceededError):
            b.result(1)
        assert i.result(1) == iwant
        assert _counter("serving.generation.evict_deadline") - ev0 == 1
        assert eng.parked_count == 0
    finally:
        eng.close()


def test_qos_demand_weighting_matches_jax(lm48):
    """Queued interactive work weighs 8x batch (2.0 against 0.25) in both
    packages, and the autoscale signal reads it."""
    _reg("lat:interactive;bulk:batch")
    kw = dict(max_slots=2, max_len=48, buckets=(16,), start=False)
    (jhot, hot), (jcold, cold) = _engines(lm48, **kw), _engines(lm48, **kw)
    try:
        for p in _prompts(8, seed=40):
            for h, c in ((hot, cold), (jhot, jcold)):
                h.submit(p, max_new_tokens=3, tenant="lat")
                c.submit(p, max_new_tokens=3, tenant="bulk")
        assert hot.qos_demand() == jhot.qos_demand() == pytest.approx(16.0)
        assert cold.qos_demand() == jcold.qos_demand() == pytest.approx(2.0)
        want_hot = health.autoscale_signal(engines=[hot])
        want_cold = health.autoscale_signal(engines=[cold])
        assert want_hot == jhealth.autoscale_signal(engines=[jhot])
        assert want_cold == jhealth.autoscale_signal(engines=[jcold])
        assert want_hot > want_cold >= 1
    finally:
        for e in (hot, cold, jhot, jcold):
            e.close()


# -- router: class placement and parked migration ----------------------------


def _live_one(e, tenant, seed):
    e.submit(_prompts(1, seed=seed)[0], max_new_tokens=30, tenant=tenant)
    for _ in range(100):
        if e.live_slots == 1:
            break
        e._tick_once()
    assert e.live_slots == 1


@pytest.mark.parametrize("case", ["interactive_avoids", "batch_packs"])
def test_router_class_aware_placement(lm48, case):
    """Interactive avoids the batch-heavy replica even when it is the less
    loaded one; batch packs onto the replica running batch work when the
    loads tie. Both packages pick the same replica."""
    _reg("lat:interactive;bulk:batch")
    picks = []
    for pkg in (0, 1):
        kw = dict(max_slots=2, max_len=48, buckets=(16,), start=False)
        e0, e1 = _engine(lm48, pkg, **kw), _engine(lm48, pkg, **kw)
        router_cls = (JaxRouter, GenerationRouter)[pkg]
        try:
            if case == "interactive_avoids":
                _live_one(e0, "bulk", 50)            # load 0.5, batch 1
                for p in _prompts(2, seed=51):
                    e1.submit(p, max_new_tokens=3, tenant="lat")  # 1.0
                assert e0.load < e1.load and e0.batch_live == 1
                s = router_cls([e0, e1]).submit(
                    _prompts(1, seed=52)[0], max_new_tokens=3, tenant="lat")
            else:
                _live_one(e0, "bulk", 53)
                _live_one(e1, "lat", 54)
                assert e0.load == e1.load == 0.5
                s = router_cls([e0, e1]).submit(
                    _prompts(1, seed=55)[0], max_new_tokens=3, tenant="bulk")
            picks.append([e0, e1].index(s._engine))
        finally:
            e0.close()
            e1.close()
    assert picks == [1, 1] if case == "interactive_avoids" else [0, 0]


def _migrate(lm48, pkg, bp, ip):
    kw = dict(max_slots=1, max_len=48, buckets=(16, 32), start=False)
    src, dst = _engine(lm48, pkg, **kw), _engine(lm48, pkg, **kw)
    router_cls = (JaxRouter, GenerationRouter)[pkg]
    mod = (jtele, telemetry)[pkg]
    try:
        b = src.submit(bp, max_new_tokens=8, tenant="bulk")
        for _ in range(100):
            if src.live_slots == 1 and len(b.tokens) >= 2:
                break
            src._tick_once()
        i = src.submit(ip, max_new_tokens=20, tenant="lat")
        src._tick_once()                           # park b, admit i
        assert src.parked_count == 1
        mig0 = _counter("serving.generation.qos.migrated", mod)
        assert router_cls([src, dst]).rebalance_parked() == 1
        assert _counter("serving.generation.qos.migrated", mod) - mig0 == 1
        assert src.parked_count == 0 and b._engine is dst
        for _ in range(400):
            if b._future.done() and i._future.done():
                break
            src._tick_once()
            dst._tick_once()
        return b.result(1), i.result(1)
    finally:
        src.close()
        dst.close()


def test_router_rebalance_parked_migration(lm48, tele):
    """A parked session migrates to the peer: eject_parked -> adopt
    re-prefills its whole context there, the ORIGINAL stream keeps
    delivering, and the tokens equal the JAX router's, the uninterrupted
    run's, and a fresh submit of the full context on the receiver."""
    _reg("lat:interactive;bulk:batch")
    (bp,), (ip,) = _prompts(1, seed=60), _prompts(1, seed=61)
    with GenerationEngine(lm48[2], max_slots=1, max_len=48,
                          buckets=(16, 32)) as base_eng:
        base = base_eng.generate(bp, max_new_tokens=8)
    got = _migrate(lm48, 1, bp, ip)
    jgot = _migrate(lm48, 0, bp, ip)
    assert got == jgot
    assert got[0] == base, "the migrated stream diverged"
    assert len(got[1]) == 20


def test_rebalance_parked_no_longer_raises(lm48):
    """The parent port raised NotImplementedError here; a fleet with
    nothing parked now migrates nothing."""
    qos.install(None)
    engines = [GenerationEngine(lm48[2], max_slots=1, max_len=48,
                                buckets=(16,), start=False)
               for _ in range(2)]
    try:
        assert GenerationRouter(engines).rebalance_parked() == 0
    finally:
        for e in engines:
            e.close()


# -- a three-tenant mix ------------------------------------------------------


def test_chaos_acceptance(lm48, tele):
    """An interactive trickle, standard traffic and a batch flood over a
    3-slot slab: the slab fills with batch work, interactive arrivals
    preempt into the park region, and every stream of every tenant ends
    bit-exact with an uncontended run and with the JAX engine's, with no
    program built past the warmed set."""
    _reg("lat:interactive;api:standard;bulk:batch")
    bulk_p, api_p, lat_p = (_prompts(5, seed=70), _prompts(2, seed=71),
                            _prompts(3, seed=72))
    with GenerationEngine(lm48[2], max_slots=3, max_len=48,
                          buckets=(16,)) as base_eng:
        base = ([base_eng.generate(p, max_new_tokens=8) for p in bulk_p],
                [base_eng.generate(p, max_new_tokens=5) for p in api_p],
                [base_eng.generate(p, max_new_tokens=3) for p in lat_p])
    out = []
    for pkg in (1, 0):
        eng = _engine(lm48, pkg, max_slots=3, max_len=48, buckets=(16,),
                      start=False)
        mod = (jtele, telemetry)[pkg]
        try:
            eng.warm()
            eng._fork_fn()   # the preemption path's one (shared) program
            m0 = eng.cache.misses
            pre0 = _counter("serving.generation.preemptions", mod)
            bulk_s = [eng.submit(p, max_new_tokens=8, tenant="bulk")
                      for p in bulk_p]
            for _ in range(200):
                if eng.live_slots == 3:
                    break
                eng._tick_once()
            assert eng.live_slots == 3 and eng.batch_live == 3
            api_s = [eng.submit(p, max_new_tokens=5, tenant="api")
                     for p in api_p]
            lat_s = [eng.submit(p, max_new_tokens=3, tenant="lat")
                     for p in lat_p]
            _drive(eng, bulk_s + api_s + lat_s)
            out.append(tuple([s.result(1) for s in group]
                             for group in (bulk_s, api_s, lat_s)))
            assert _counter("serving.generation.preemptions", mod) > pre0
            assert eng.cache.misses == m0, "built past the warmed set"
            assert eng.parked_count == 0 and eng.live_slots == 0
        finally:
            eng.close()
    assert out[0] == out[1] == base


# -- observability -------------------------------------------------------------


def test_labeled_names_and_prom_format_match_jax(tele):
    """The labeled qos series render as one Prometheus family with real
    label sets, byte for byte as the JAX package renders them."""
    texts = []
    for mod in (telemetry, jtele):
        mod.reset()
        name = mod.labeled("qos.admitted", tenant="acme",
                           **{"class": "interactive"})
        assert name == "qos.admitted|class=interactive|tenant=acme"
        mod.counter(name).inc(3)
        mod.counter(mod.labeled("qos.admitted", tenant="bulkco",
                                **{"class": "batch"})).inc()
        mod.counter("qos_plain").inc()
        texts.append(mod.prom_text(refresh_memory=False))
    text = texts[0]
    assert ('mxnet_qos_admitted{class="interactive",tenant="acme"} 3'
            in text)
    assert 'mxnet_qos_admitted{class="batch",tenant="bulkco"} 1' in text
    assert text.count("# TYPE mxnet_qos_admitted counter") == 1
    assert "mxnet_qos_plain 1" in text
    assert texts[0] == texts[1]


def test_telemetry_report_qos_line(tele, tmp_path, capsys):
    """`tools/telemetry_report.py` renders the port's snapshot's qos line
    as it renders the JAX package's."""
    from tools import telemetry_report

    outs = []
    for mod in (telemetry, jtele):
        mod.reset()
        for cls, tenant, n in (("interactive", "acme", 7),
                               ("batch", "bulk", 4)):
            mod.counter(mod.labeled("qos.admitted", tenant=tenant,
                                    **{"class": cls})).inc(n)
        mod.counter(mod.labeled("qos.rejected", tenant="bulk",
                                **{"class": "batch"})).inc(2)
        mod.counter(mod.labeled("qos.preempted", tenant="bulk",
                                **{"class": "batch"})).inc()
        for us in (900.0, 1100.0):
            mod.histogram(mod.labeled("qos.ttft_us", tenant="acme",
                                      **{"class": "interactive"})).record(us)
        mod.histogram(mod.labeled("qos.ttft_us", tenant="bulk",
                                  **{"class": "batch"})).record(250000.0)
        path = tmp_path / "telemetry.json"
        path.write_text(json.dumps(mod.snapshot()))
        assert telemetry_report.main([str(path)]) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("qos:") or "worst tenant" in ln])
    assert outs[0] == outs[1]
    text = "\n".join(outs[0])
    assert ("qos: interactive 7 admitted, batch 4 admitted/2 rejected/1 "
            "preempted") in text
    assert "worst tenant TTFT p99: bulk 250.00 ms" in text


def test_attach_slo_rows_match_jax():
    """One sanitized per-tenant TTFT burn objective per declared tenant,
    idempotent, the same rows as the JAX package's."""
    reg = qos.TenantRegistry(qos.parse_spec("acme:interactive;bulk:batch"))
    jreg = jqos.TenantRegistry(
        jqos.parse_spec("acme:interactive;bulk:batch"))
    assert reg.slo_specs() == jreg.slo_specs() == [
        "qos.ttft_us|tenant=acme:p99<500ms",
        "qos.ttft_us|tenant=bulk:p99<10000ms"]
    prev = health.enabled()
    health.enable()
    try:
        tracker = health.tracker()
        n0 = len(tracker.objectives)
        assert qos.attach_slo(reg, tracker) == 2
        assert qos.attach_slo(reg, tracker) == 0       # idempotent
        added = tracker.objectives[n0:]
        assert [o.metric for o in added] == [
            "qos.ttft_us|tenant=acme", "qos.ttft_us|tenant=bulk"]
        for o in added:
            assert "|" not in o.key and "=" not in o.key
            assert o.key in tracker._samples
    finally:
        health.enable(prev)
        health.reset()
