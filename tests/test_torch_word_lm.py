"""The slice as a whole on the CPU: `example/gluon/word_language_model.py`'s
`RNNModel` (Embedding -> Dropout -> 2-layer LSTM -> Dropout -> Dense,
untied) driven by the example's loop (`chip_smoke.word_lm_iteration`:
truncated BPTT, `record()`, the backward, SGD through `gluon.Trainer`
with the elementwise ``clip_gradient``) at `chip_smoke.LM_SMALL`'s widths
(vocab 64, 32 units, bptt 8, batch 4, dropout 0), from the same numpy
weights, two steps over the example's synthetic corpus: the port (its
``model.rnn`` hybridized, and eager) against the JAX package (eager). The
losses, every weight after the steps and the final hidden states agree
within rtol 1e-4 / atol 1e-5 (`tests/python/unittest/test_gluon_rnn.py`'s
atol 1e-5 on values that two SGD steps at rate 2 have moved).
"""
import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = {"rtol": 1e-4, "atol": 1e-5}


@pytest.fixture(scope="module")
def jax_run():
    return cs.word_lm_small_run(jmx, jmx.cpu(), hybridize=False)


@pytest.mark.parametrize("hybridize", [True, False],
                         ids=["hybridized", "eager"])
def test_word_lm_two_steps_match_jax(jax_run, hybridize):
    losses, state = cs.word_lm_small_run(mx, mx.cpu(), hybridize=hybridize)
    want_losses, want_state = jax_run
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert sorted(state) == sorted(want_state)
    assert "hidden 0" in state and "rnn.l1_h2h_weight" in state
    for k in want_state:
        np.testing.assert_allclose(state[k], want_state[k], err_msg=k, **TOL)


def test_word_lm_losses_fall_and_hidden_is_detached():
    """Four more steps over the same two windows: the loss falls, and the
    hidden state handed to the next step carries no graph."""
    cfg = dict(cs.LM_SMALL, steps=2)
    ctx = mx.cpu()
    ex, model, trainer, loss_fn = cs.word_lm_setup(mx, ctx, cfg,
                                                   weights_seed=0)
    windows = cs.word_lm_windows(ex, cfg, 2, seed=1)
    hidden = model.begin_state(func=mx.nd.zeros, batch_size=cfg["batch"],
                               ctx=ctx)
    means = []
    for step in range(6):
        x, y = windows[step % 2]
        loss, hidden = cs.word_lm_iteration(
            mx, model, trainer, loss_fn, mx.nd.array(x, ctx=ctx),
            mx.nd.array(y, ctx=ctx), hidden, cfg)
        means.append(float(loss.mean().asnumpy()))
        assert all(not h.detach()._data.requires_grad for h in hidden)
    assert means[-1] < means[0]
    assert np.isfinite(means).all()


def test_word_lm_flop_count_matches_the_shapes():
    flop, rec, dec = cs.word_lm_flop(cs.LM_FULL)
    assert flop == rec + dec
    # by hand: 1120 tokens, 2 layers of 4 x 1500 x (1500 + 1500), a
    # 1500 x 33278 decoder, each 2 x forward + 2 x 2 x backward
    tokens = 35 * 32
    assert rec == 3 * 2 * tokens * 2 * 4 * 1500 * 3000
    assert dec == 3 * 2 * tokens * 1500 * 33278
    assert 575e9 < flop < 580e9
