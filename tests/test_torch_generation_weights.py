"""Engines over one model each serve their own weights (ROADMAP C.5).

The JAX `GenerationEngine` takes ``params`` as its own argument
(`mxnet_tpu/serving/generation/engine.py:200`), so two engines over one
model serve two weight sets. The port's engines read the model's
parameters in place; an engine built over a model that another engine
serves must not change what that engine serves.

The inputs are ROADMAP C.5's: the model of vocab 64, d_model 32, 2 heads,
d_ff 64, 2 layers, max_len 48, fp32; two weight sets
`init_params(PRNGKey(0))` and `(1)`, carried to the port by
`params_from_jax`; engine A on set 0 with 2 slots and the one prefill
bucket 8, prompt ``[3, 5, 7, 9]``, 8 new tokens; then engine B on set 1
over the same model; then A again. Streams are held to the JAX package's
exactly (``==``: argmax ties break at the first index in both packages).
"""
import numpy as np
import pytest

import jax

from mxnet_tpu import parallel as par
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving.generation import GenerationEngine

PROMPT = np.array([3, 5, 7, 9], np.int32)
NEW = 8
ENGINE = {"max_slots": 2, "max_len": 48, "buckets": (8,)}


@pytest.fixture(scope="module")
def sets():
    """(JAX model, weight set 0, weight set 1, the JAX streams of each)."""
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    cfg = JaxConfig(vocab_size=64, d_model=32, n_heads=2, d_ff=64,
                    n_layers=2, max_len=48, dtype="float32")
    jlm = JaxLM(cfg, mesh)
    p0, p1 = ({k: np.asarray(v) for k, v in
               jlm.init_params(jax.random.PRNGKey(seed)).items()}
              for seed in (0, 1))
    want = []
    for p in (p0, p1):
        with JaxEngine(jlm, p, **ENGINE) as jeng:
            want.append(jeng.generate(PROMPT, max_new_tokens=NEW))
    assert want[0] != want[1], "the two sets must give different streams"
    return jlm, p0, p1, want


def _model(jlm):
    return TransformerLM(TransformerLMConfig(**vars(jlm.cfg)), device="cpu")


def test_second_engine_keeps_the_first_engines_weights(sets):
    """A's stream is the JAX package's on set 0 before B is built over the
    model and after; B serves set 1, as the JAX package's B does."""
    jlm, p0, p1, want = sets
    lm = _model(jlm)
    a = GenerationEngine(lm, params_from_jax(p0, device="cpu"), **ENGINE)
    try:
        assert a.generate(PROMPT, max_new_tokens=NEW) == want[0]
        b = GenerationEngine(lm, params_from_jax(p1, device="cpu"), **ENGINE)
        try:
            assert a.generate(PROMPT, max_new_tokens=NEW) == want[0]
            assert b.generate(PROMPT, max_new_tokens=NEW) == want[1]
            assert a.generate(PROMPT, max_new_tokens=NEW) == want[0]
        finally:
            b.close()
    finally:
        a.close()


def test_swap_with_another_engine_open_changes_only_that_engine(sets):
    """`swap_weights` on A while B is open succeeds and moves A alone: A
    serves set 1 after it and set 0 again after a swap back, and B keeps
    serving set 1 throughout."""
    jlm, p0, p1, want = sets
    lm = _model(jlm)
    a = GenerationEngine(lm, params_from_jax(p0, device="cpu"), **ENGINE)
    b = GenerationEngine(lm, params_from_jax(p1, device="cpu"), **ENGINE)
    try:
        assert a.swap_weights(p1) == 1
        assert a.generate(PROMPT, max_new_tokens=NEW) == want[1]
        assert b.generate(PROMPT, max_new_tokens=NEW) == want[1]
        assert a.swap_weights(p0) == 2
        assert a.generate(PROMPT, max_new_tokens=NEW) == want[0]
        assert b.generate(PROMPT, max_new_tokens=NEW) == want[1]
    finally:
        b.close()
        a.close()


def test_engines_without_params_share_the_models_values(sets):
    """Engines built with ``params=None`` serve what the model's
    parameters held when they were built; a swap on one of them leaves
    the other on those values."""
    jlm, p0, p1, want = sets
    lm = _model(jlm)
    lm.load_state_dict(params_from_jax(p0, device="cpu"))
    a = GenerationEngine(lm, **ENGINE)
    b = GenerationEngine(lm, **ENGINE)
    try:
        assert a.swap_weights(p1) == 1
        assert b.generate(PROMPT, max_new_tokens=NEW) == want[0]
        assert a.generate(PROMPT, max_new_tokens=NEW) == want[1]
        assert b.generate(PROMPT, max_new_tokens=NEW) == want[0]
    finally:
        b.close()
        a.close()
