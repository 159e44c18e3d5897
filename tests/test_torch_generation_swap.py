"""The port's live weight swap of the generation engine
(`GenerationEngine.swap_weights`, version cohorts, `weights_snapshot`)
on the CPU, mirroring `tests/python/unittest/test_rollout.py:308-430`.

The model is that suite's `lm2` (vocab 64, d_model 32, 2 heads, d_ff 64,
2 layers, max_len 48, fp32) with its two weight versions
`init_params(PRNGKey(0))` and `PRNGKey(1)`, carried over by
`params_from_jax`. A swapped or pinned session's stream is held bit for
bit (``==``) to a fresh port engine on that version, and the first
version's streams to the JAX engine's (argmax ties break at the first
index in both packages).
"""
import numpy as np
import pytest
import torch

import jax

from mxnet_tpu import parallel as par
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu_torch import health
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving import WeightSet, warmup
from mxnet_tpu_torch.serving.generation import (CheckpointDraft,
                                                GenerationEngine)

VOCAB = 64


def _jax_params(d_model=32, seed=0):
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    cfg = JaxConfig(vocab_size=VOCAB, d_model=d_model, n_heads=2,
                    d_ff=2 * d_model, n_layers=2, max_len=48,
                    dtype="float32")
    jlm = JaxLM(cfg, mesh)
    return jlm, {k: np.asarray(v) for k, v in
                 jlm.init_params(jax.random.PRNGKey(seed)).items()}


def _port(jlm, params):
    lm = TransformerLM(TransformerLMConfig(**vars(jlm.cfg)), device="cpu")
    lm.load_state_dict(params_from_jax(params, device="cpu"))
    return lm


@pytest.fixture(scope="module")
def lm2():
    """(JAX model, version 0 and 1 in JAX names, a port model holding
    version 0)."""
    jlm, p0 = _jax_params(seed=0)
    _, p1 = _jax_params(seed=1)
    return jlm, p0, p1, _port(jlm, p0)


@pytest.fixture
def lm(lm2):
    """A fresh port model on version 0: a swap writes into the model's
    parameters."""
    jlm, p0, _, _ = lm2
    return _port(jlm, p0)


def _prompts(n, lo=2, hi=10, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _alone(jlm, params, prompts, new=8, **kw):
    """Each prompt's stream on a fresh port engine over `params`, with the
    slab shape of the engine under test (``max_slots=4, max_len=48``
    unless `kw` says otherwise)."""
    kw = dict(dict(max_slots=4, max_len=48), **kw)
    with GenerationEngine(_port(jlm, params), **kw) as eng:
        return [eng.generate(p, max_new_tokens=new) for p in prompts]


def test_engine_swap_zero_captures_bit_parity(lm2, lm):
    """After a swap, new sessions run the new weights bit for bit as a
    fresh engine does, nothing is built again, and a second publish of
    the same version is a no-op; the old streams are the JAX engine's."""
    jlm, p0, p1, _ = lm2
    prompts = _prompts(2, seed=3)
    with GenerationEngine(lm, max_slots=4, max_len=48) as eng:
        warmup(eng)
        old = [eng.generate(p, max_new_tokens=8) for p in prompts]
        misses = eng.cache.misses
        assert eng.swap_weights(p1) == 1
        assert eng.stats()["weights_version"] == 1
        new = [eng.generate(p, max_new_tokens=8) for p in prompts]
        assert eng.cache.misses == misses
        assert eng.swap_weights(p1, version=1) is None   # idempotent
        assert eng.weights_version == 1
    assert new != old
    assert new == _alone(jlm, p1, prompts)
    with JaxEngine(jlm, p0, max_slots=4, max_len=48) as jeng:
        assert old == [jeng.generate(p, max_new_tokens=8) for p in prompts]


def test_engine_swap_rejects_mismatched_params(lm2, lm):
    """Other names or shapes are refused and change nothing; names of
    either package are accepted."""
    jlm, p0, p1, _ = lm2
    with GenerationEngine(lm, max_slots=2, max_len=48) as eng:
        before = lm.embed.clone()
        with pytest.raises(MXNetError):
            eng.swap_weights({"nope": np.zeros(3, np.float32)})
        bad = dict(p1)
        bad["l0.wqkv"] = np.zeros((3, 3), np.float32)
        with pytest.raises(MXNetError):
            eng.swap_weights(bad)
        assert eng.weights_version == 0 and torch.equal(lm.embed, before)
        port_names = params_from_jax(p1, device="cpu")
        assert eng.swap_weights(port_names) == 1
        assert torch.equal(lm.embed, port_names["embed"])


def test_mid_stream_swap_pins_sessions(lm2, lm):
    """A session admitted before the swap finishes bit-exact on its
    admission-time weights while one admitted after runs the new ones:
    cohort ticks, nothing built, and the old version's copy released once
    its session drains."""
    jlm, p0, p1, _ = lm2
    pr_a, pr_b = _prompts(2, lo=5, hi=8, seed=11)
    want_a = _alone(jlm, p0, [pr_a], new=10)[0]
    want_b = _alone(jlm, p1, [pr_b], new=10)[0]
    eng = GenerationEngine(lm, max_slots=4, max_len=48, start=False)
    try:
        warmup(eng)
        sa = eng.submit(pr_a, max_new_tokens=10)
        for _ in range(4):
            eng._tick_once()                     # A is mid-stream on v0
        misses = eng.cache.misses
        assert eng.swap_weights(p1) == 1
        assert eng.live_weight_versions == [0, 1]
        sb = eng.submit(pr_b, max_new_tokens=10)
        for _ in range(25):
            eng._tick_once()
        assert sa.result(timeout=5) == want_a    # pinned old, bit-exact
        assert sb.result(timeout=5) == want_b    # new weights, bit-exact
        assert eng.cache.misses == misses
        assert eng.live_weight_versions == [1]   # v0 drained and released
        assert sorted(eng._param_sets) == [1]
        # the parameters hold the current version between ticks
        assert torch.equal(lm.embed, torch.tensor(p1["embed"]))
    finally:
        eng.close()


def test_prefix_cache_version_stamping(lm2, lm):
    """A prefix cached under old weights never serves a post-swap fork:
    entries are stamped with their version and evicted at the swap."""
    prompt = np.arange(1, 13, dtype=np.int32)
    _, _, p1, _ = lm2
    with GenerationEngine(lm, max_slots=4, max_len=48, prefix_cache=True,
                          prefix_min_tokens=4) as eng:
        eng.generate(prompt, max_new_tokens=4)
        assert eng.prefix_match_len(prompt) > 0      # cached under v0
        eng.swap_weights(p1)
        assert eng.prefix_match_len(prompt) == 0
        assert len(eng.prefix_cache) == 0
        eng.generate(prompt, max_new_tokens=4)
        assert eng.prefix_match_len(prompt) > 0      # cached under v1


def test_swap_during_speculative_decode(lm2, lm):
    """A swap between verify ticks: the pinned session's verify keeps its
    admission-time weights (the new draft's proposals are corrected bit
    for bit), the new session runs the new weights end to end."""
    jlm, p0, p1, _ = lm2
    djlm, dp0 = _jax_params(d_model=16, seed=7)
    _, dp1 = _jax_params(d_model=16, seed=8)
    pr_a, pr_b = _prompts(2, lo=5, hi=8, seed=13)
    kw = dict(max_slots=4, max_len=40, spec_k=3)
    want_a = _alone(jlm, p0, [pr_a], new=10,
                    draft=CheckpointDraft(_port(djlm, dp0)), **kw)[0]
    want_b = _alone(jlm, p1, [pr_b], new=10,
                    draft=CheckpointDraft(_port(djlm, dp1)), **kw)[0]
    draft = CheckpointDraft(_port(djlm, dp0))
    eng = GenerationEngine(lm, draft=draft, start=False, **kw)
    try:
        warmup(eng)
        sa = eng.submit(pr_a, max_new_tokens=10)
        for _ in range(2):
            eng._tick_once()
        misses = eng.cache.misses
        eng.swap_weights(p1, draft_params=dp1)
        assert torch.equal(draft.model.embed, torch.tensor(dp1["embed"]))
        sb = eng.submit(pr_b, max_new_tokens=10)
        for _ in range(30):
            eng._tick_once()
        assert sa.result(timeout=5) == want_a
        assert sb.result(timeout=5) == want_b
        assert eng.cache.misses == misses
        version, params, dparams = eng.weights_snapshot()
        assert version == 1 and set(dparams) == set(
            dict(draft.model.named_parameters()))
        np.testing.assert_array_equal(params["layers.1.w2"], p1["l1.w2"])
    finally:
        eng.close()


def test_swap_weightset_rollback_and_refs(lm2, lm):
    """A `WeightSet` is pinned while a session decodes under it and
    released once none does; a rollback to a still-pinned version reuses
    its copy; the swaps are journaled; a snapshot swaps back exactly."""
    jlm, p0, p1, _ = lm2
    (pr,) = _prompts(1, lo=5, hi=8, seed=17)
    was = health.enabled()
    health.reset()
    health.enable()
    eng = GenerationEngine(lm, max_slots=2, max_len=48, start=False)
    try:
        _, snap, _ = eng.weights_snapshot()
        ws = WeightSet(7, p1)
        assert eng.swap_weights(ws) == 7 and ws.refs == 2
        s = eng.submit(pr, max_new_tokens=6)
        eng._tick_once()                          # a session on v7
        assert eng.swap_weights(WeightSet(8, p0)) == 8
        assert ws.refs == 2                       # still pinned by s
        assert eng.swap_weights(p1, version=7) == 7   # rollback: pinned copy
        while not s.done:
            eng._tick_once()
        assert s.result() == _alone(jlm, p1, [pr], new=6, max_slots=2)[0]
        eng._tick_once()
        assert eng.swap_weights(snap, version=9) == 9
        assert torch.equal(lm.embed, torch.tensor(p0["embed"]))
        kinds = [e["kind"] for e in health.events()]
        assert kinds.count("rollout_swap") == 4
        assert "rollout_drained" in kinds
    finally:
        eng.close()
        health.reset()
        health.enable(was)
    assert ws.refs == 1                           # the creator's only


def test_swap_refused_while_another_engine_shares_the_model(lm2, lm):
    """Engines over one model each serve their own weights (ROADMAP C.5,
    fixed): a swap on one while another open engine shares the model is no
    longer refused, and changes only the engine swapped. Each stream is
    held bit for bit to a fresh engine on its version."""
    jlm, p0, p1, _ = lm2
    prompt = np.array([3, 5, 7, 9], np.int32)
    want0 = _alone(jlm, p0, [prompt], max_slots=1)[0]
    want1 = _alone(jlm, p1, [prompt], max_slots=1)[0]
    a = GenerationEngine(lm, max_slots=1, max_len=48, start=False)
    b = GenerationEngine(lm, max_slots=1, max_len=48, start=False)
    assert a.swap_weights(p1) == 1
    assert a.generate(prompt, max_new_tokens=8) == want1
    assert b.generate(prompt, max_new_tokens=8) == want0
    assert a.generate(prompt, max_new_tokens=8) == want1
    b.close()
    a.close()
