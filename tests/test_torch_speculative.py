"""The port's speculative lane (`TransformerLM.verify_step`,
`serving.generation.speculative` and the engine's verify tick) held to
the JAX package on the CPU, mirroring
`tests/python/unittest/test_generation_scale.py:156-291`.

The model is that suite's `lm64` (vocab 64, d_model 32, 2 heads, d_ff 64,
2 layers, max_len 64, fp32, `init_params(PRNGKey(0))`), carried over by
`params_from_jax`; the checkpoint draft is its `_model(n_layers=1,
d_model=16, seed=9)`. Tolerances: verify logits against the JAX method at
rtol 1e-3 / atol 1e-4 (the JAX suite's bound for the cache path); the
verify program against k + 1 of the port's own decode steps, and every
speculative stream against the plain lane's, bit for bit (`array_equal`,
``==``), the property the unrolled verify exists for; streams against the
JAX engine's exactly (argmax breaks ties at the first index in both
packages).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import parallel as par
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu.serving.generation import NgramDraft as JaxNgramDraft
from mxnet_tpu.serving.generation import load_draft as jax_load_draft
from mxnet_tpu.serving.generation import save_draft as jax_save_draft
from mxnet_tpu_torch.base import MXNetError, getenv
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving import warmup
from mxnet_tpu_torch.serving.generation import (CheckpointDraft,
                                                GenerationEngine,
                                                NgramDraft, load_draft,
                                                save_draft, speculative)

VOCAB = 64
TOL = dict(rtol=1e-3, atol=1e-4)


def _jax_model(max_len=64, n_layers=2, d_model=32, seed=0):
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    cfg = JaxConfig(vocab_size=VOCAB, d_model=d_model, n_heads=2,
                    d_ff=2 * d_model, n_layers=n_layers, max_len=max_len,
                    dtype="float32")
    jlm = JaxLM(cfg, mesh)
    return jlm, jlm.init_params(jax.random.PRNGKey(seed))


def _port(jlm, jparams):
    lm = TransformerLM(TransformerLMConfig(**vars(jlm.cfg)), device="cpu")
    lm.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu"))
    return lm


@pytest.fixture(scope="module")
def lm64():
    """(JAX model, its params, the port's model with the same weights)."""
    jlm, jparams = _jax_model()
    return jlm, jparams, _port(jlm, jparams)


@pytest.fixture(scope="module")
def draft64():
    """The checkpoint draft's JAX model and params (1 layer, d_model 16)."""
    return _jax_model(n_layers=1, d_model=16, seed=9)


def _prompts(n, lo=2, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the model's verify step
# ---------------------------------------------------------------------------


def test_verify_step_bit_exact_vs_sequential_decode(lm64):
    """The verify step (k + 1 unrolled decode steps) gives bit-identical
    logits AND slab to k + 1 sequential `decode_step` calls of the port,
    and the JAX verify step's logits within the cache path's bound."""
    jlm, jparams, lm = lm64
    rng = np.random.RandomState(4)
    toks = np.zeros(8, np.int64)
    toks[:6] = rng.randint(1, VOCAB, 6)
    ck, cv = lm.init_cache(3, 32)
    lm.prefill(ck, cv, torch.from_numpy(toks), 6, 1)
    K = 5
    blk = rng.randint(1, VOCAB, (3, K))
    pos = np.array([0, 6, 0])
    vck, vcv = ck.clone(), cv.clone()
    vl, _, _ = lm.verify_step(vck, vcv, torch.from_numpy(blk),
                              torch.from_numpy(pos))
    assert vl.shape == (3, K, VOCAB) and vl.dtype == torch.float32
    seq = [lm.decode_step(ck, cv, torch.from_numpy(blk[:, i]),
                          torch.from_numpy(pos + i))[0] for i in range(K)]
    assert torch.equal(vl, torch.stack(seq, 1))
    assert torch.equal(vck, ck) and torch.equal(vcv, cv)

    jck, jcv = jlm.init_cache(3, 32)
    _, jck, jcv = jax.jit(jlm.prefill)(jparams, jck, jcv,
                                       jnp.asarray(toks, jnp.int32),
                                       jnp.asarray(6), jnp.asarray(1))
    jl, _, _ = jax.jit(jlm.verify_step)(jparams, jck, jcv,
                                        jnp.asarray(blk, jnp.int32),
                                        jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(vl.numpy(), np.asarray(jl), **TOL)
    assert np.array_equal(vl.numpy().argmax(-1), np.asarray(jl).argmax(-1))


# ---------------------------------------------------------------------------
# the speculative lane: bit-exact greedy parity
# ---------------------------------------------------------------------------


def test_spec_vs_plain_bit_exact_ragged(lm64):
    """Speculative greedy decode (n-gram draft, k = 4) is bit-exact with
    the plain lane over 16 ragged sessions, sequentially and under
    concurrent submission through a 3-slot slab, builds nothing after
    warm-up, commits more than one token a verified slot, and equals the
    JAX package's speculative streams."""
    jlm, jparams, lm = lm64
    prompts = _prompts(16, seed=5)
    news = [3 + (i % 6) for i in range(len(prompts))]
    kw = dict(max_slots=3, max_len=48, buckets=(8, 16))
    with GenerationEngine(lm, **kw) as plain:
        ref = [plain.generate(p, max_new_tokens=n)
               for p, n in zip(prompts, news)]
    with GenerationEngine(lm, spec_k=4, draft=NgramDraft(), **kw) as spec:
        assert spec.warm()["compiles"] == 2 + 1    # prefills + verify
        m0 = spec.cache.misses
        got = [spec.generate(p, max_new_tokens=n)
               for p, n in zip(prompts, news)]
        streams = [spec.submit(p, max_new_tokens=n)
                   for p, n in zip(prompts, news)]
        got2 = [s.result(timeout=60) for s in streams]
        assert spec.cache.misses == m0, "spec lane built mid-stream"
        assert not any(k[0] == "decode" for k in spec.cache.keys())
        committed, vslots = spec.spec_committed, spec.spec_verified_slots
    assert got == ref and got2 == ref
    assert vslots > 0 and committed / vslots > 1.0, \
        f"speculation never beat plain decode ({committed}/{vslots})"
    with JaxEngine(jlm, jparams, spec_k=4, draft=JaxNgramDraft(),
                   **kw) as jspec:
        want = [s.result(timeout=120) for s in
                [jspec.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, news)]]
    assert got2 == want


def test_spec_eos_mid_block(lm64):
    """EOS inside a committed verify block ends the session AT the EOS
    token, as the plain lane does (later tokens of the block dropped)."""
    _, _, lm = lm64
    (p,) = _prompts(1, seed=6)
    kw = dict(max_slots=2, max_len=48, buckets=(16,))
    with GenerationEngine(lm, **kw) as plain:
        full = plain.generate(p, max_new_tokens=12)
        k = max(i for i, t in enumerate(full) if t not in full[:i])
        ref = plain.generate(p, max_new_tokens=12, eos_id=full[k])
    with GenerationEngine(lm, spec_k=4, draft=NgramDraft(), **kw) as spec:
        assert spec.generate(p, max_new_tokens=12) == full
        got = spec.generate(p, max_new_tokens=12, eos_id=full[k])
        assert spec.live_slots == 0
    assert got == ref == full[:k + 1]


def test_ngram_draft_matches_jax():
    """The n-gram draft proposes what the JAX package's proposes, on
    histories with and without a repeated n-gram."""
    class Sess:
        def __init__(self, prompt, toks):
            self.prompt = np.asarray(prompt, np.int32)
            self.stream = type("S", (), {"tokens": list(toks)})()

    rng = np.random.RandomState(21)
    sessions = [None, Sess([1, 2, 3, 4, 1, 2], [3]), Sess([7], []),
                Sess(rng.randint(1, 5, 40), rng.randint(1, 5, 9)), None,
                Sess([5, 6, 5, 6, 5], [6, 9, 5, 6])]
    for k in (1, 3, 4):
        got = NgramDraft().propose(k, sessions)
        want = JaxNgramDraft().propose(k, sessions)
        assert got.dtype == np.int32 and np.array_equal(got, want), k


def test_checkpoint_draft_bit_exact_and_roundtrip(lm64, draft64, tmp_path):
    """A `CheckpointDraft` from a `save_draft` file drives the lane to the
    plain streams bit for bit; a draft saved by either package loads in
    the other with the same config and parameters; warm-up builds 2
    prefills + 1 verify + 2 draft prefills + 1 draft step, and traffic
    nothing more."""
    _, _, lm = lm64
    jdlm, jdparams = draft64
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_save_draft(jpath, jdlm, jdparams)
    dlm, dparams = load_draft(jpath, device="cpu")
    assert dlm.cfg == TransformerLMConfig(**vars(jdlm.cfg))
    assert dlm.device.type == "cpu" and set(dparams) == set(
        dict(dlm.named_parameters()))
    np.testing.assert_array_equal(dparams["layers.0.wqkv"].numpy(),
                                  np.asarray(jdparams["l0.wqkv"]))
    save_draft(ppath, dlm)
    jdlm2, jdparams2 = jax_load_draft(ppath, jdlm.mesh)
    assert jdlm2.cfg == jdlm.cfg and set(jdparams2) == set(jdparams)
    for name, v in jdparams.items():
        np.testing.assert_array_equal(np.asarray(jdparams2[name]),
                                      np.asarray(v))

    prompts = _prompts(8, seed=7)
    news = [3 + (i % 5) for i in range(len(prompts))]
    kw = dict(max_slots=3, max_len=32, buckets=(8, 16))
    with GenerationEngine(lm, **kw) as plain:
        ref = [plain.generate(p, max_new_tokens=n)
               for p, n in zip(prompts, news)]
    draft = CheckpointDraft(*load_draft(ppath, device="cpu"))
    with GenerationEngine(lm, spec_k=3, draft=draft, **kw) as eng:
        assert eng.warm()["compiles"] == 6
        m0 = eng.cache.misses
        got = [eng.generate(p, max_new_tokens=n)
               for p, n in zip(prompts, news)]
        assert eng.cache.misses == m0
        assert eng.stats()["draft_slab_bytes"] == draft.slab_bytes() > 0
    assert got == ref


def test_default_draft_from_env(lm64, draft64, tmp_path, monkeypatch):
    """The knobs carry the JAX package's defaults; with
    ``MXNET_GENERATION_SPEC_K`` and ``MXNET_GENERATION_DRAFT`` set, the
    engine builds a checkpoint draft from the file, and without the path
    the n-gram draft."""
    _, _, lm = lm64
    assert getenv("MXNET_GENERATION_SPEC_K") == 0
    assert getenv("MXNET_GENERATION_DRAFT") == ""
    assert isinstance(speculative.default_draft("cpu"), NgramDraft)
    path = str(tmp_path / "d.npz")
    jax_save_draft(path, *draft64)
    monkeypatch.setenv("MXNET_GENERATION_SPEC_K", "2")
    monkeypatch.setenv("MXNET_GENERATION_DRAFT", path)
    eng = GenerationEngine(lm, max_slots=2, max_len=24, buckets=(8,),
                           start=False)
    assert eng.spec_k == 2 and isinstance(eng.draft, CheckpointDraft)
    assert eng.draft.model.cfg.d_model == 16
    eng.close()


def test_spec_rejects_bad_config(lm64, draft64):
    """spec_k eating the model's whole positional range, a draft whose
    range cannot cover max_len + 2k, and a negative k all fail at
    construction."""
    _, _, lm = lm64
    with pytest.raises(MXNetError):
        GenerationEngine(lm, max_slots=2, max_len=64, buckets=(8,),
                         spec_k=63, draft=NgramDraft(), start=False)
    with pytest.raises(MXNetError):
        GenerationEngine(lm, max_slots=2, max_len=48, buckets=(8,),
                         spec_k=-1, start=False)
    jdlm, jdparams = _jax_model(max_len=32, n_layers=1, d_model=16, seed=9)
    short = CheckpointDraft(_port(jdlm, jdparams))
    with pytest.raises(MXNetError):
        GenerationEngine(lm, max_slots=2, max_len=48, buckets=(8,),
                         spec_k=4, draft=short, start=False)


def test_spec_near_capacity_stays_in_the_slab(lm64):
    """The slab's k scratch rows: max_len is cut to the model's range less
    k, sessions that run to capacity end there with the plain lane's
    tokens, and every verify block's rows stay inside the slab."""
    _, _, lm = lm64
    p = _prompts(1, lo=10, hi=11, seed=22)[0]
    kw = dict(max_slots=2, buckets=(16,))
    with GenerationEngine(lm, max_len=60, **kw) as plain:
        ref = plain.generate(p, max_new_tokens=50)
    eng = GenerationEngine(lm, max_len=64, spec_k=4, draft=NgramDraft(),
                           start=False, **kw)
    assert eng.max_len == 60 and eng._slab_len == 64
    seen = []
    real = eng._tick_positions

    def spy():
        pos = real()
        seen.append(int(pos.max()))
        return pos

    eng._tick_positions = spy
    warmup(eng)
    s = eng.submit(p, max_new_tokens=50)
    while not s.done:
        eng._tick_once()
    assert s.result(timeout=5) == ref
    assert max(seen) + 4 <= 63
    eng.close()
