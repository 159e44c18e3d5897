"""The port's fused RNN op (`mxnet_tpu_torch.ops.rnn`) held to the JAX
package's (`mxnet_tpu/ops/rnn.py`) on the CPU: every mode (lstm, gru,
rnn_tanh, rnn_relu), one and two directions, two layers, on both routes
(``fused``: `torch._VF`; ``step``: the recurrence written out, taken for
``cudnn_off``, the LSTM cell clip and ``use_sequence_length``), the LSTM
projection, the clip and masked lengths. The same numpy inputs go through
the port's `mx.nd.RNN` under `autograd.record()` and through the JAX op
under `jax.vjp`, with the same cotangents on the output and the final
states: outputs, final states and the gradients of the data, the flat
parameters and the initial states agree within rtol 1e-4 / atol 1e-5
(`tests/python/unittest/test_gluon_rnn.py:38-136`'s atol 1e-5); a bf16
run against the JAX op on the same bf16 values within 3e-2 (bf16's ulp
near 1 is 2^-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.ops import rnn as jrnn
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.ops import registry as treg

CPU = mx.cpu()
TOL = {"rtol": 1e-4, "atol": 1e-5}
T, N, I, H, L = 5, 3, 4, 6, 2

VARIANTS = {
    "fused": {},
    "step": {"cudnn_off": True},
    "lengths": {"use_sequence_length": True},
}
LSTM_VARIANTS = {
    "projection": {"projection_size": 4},
    "projection_step": {"projection_size": 4, "cudnn_off": True},
    "clip": {"lstm_state_clip_min": -0.2, "lstm_state_clip_max": 0.3},
    "clip_nan_lengths": {"lstm_state_clip_min": -0.5,
                         "lstm_state_clip_max": 0.5,
                         "lstm_state_clip_nan": True,
                         "use_sequence_length": True},
}
# both routes at every mode and direction; masked lengths at every mode
# (the step route), bidirectional for the LSTM
CASES = [(m, b, v) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")
         for b in (False, True) for v in ("fused", "step")]
CASES += [(m, m == "lstm", "lengths")
          for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")]
CASES += [("lstm", True, "projection"), ("lstm", False, "projection_step"),
          ("lstm", False, "clip"), ("lstm", True, "clip_nan_lengths")]


def inputs(mode, bidir, attrs, seed=0):
    rng = np.random.RandomState(seed)
    D = 2 if bidir else 1
    P = attrs.get("projection_size")
    n = trnn.rnn_param_size(L, H, I, mode, bidir, P)
    arrays = [rng.randn(T, N, I).astype(np.float32),
              rng.uniform(-0.4, 0.4, n).astype(np.float32),
              rng.randn(L * D, N, P or H).astype(np.float32)]
    if mode == "lstm":
        arrays.append(rng.randn(L * D, N, H).astype(np.float32))
    lengths = np.array([5, 2, 4], np.float32)
    return arrays, lengths


def cotangents(shapes, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def port_run(arrays, lengths, attrs, dtype=np.float32):
    nds = [mx.nd.array(a, ctx=CPU, dtype=dtype) for a in arrays]
    for a in nds:
        a.attach_grad()
    extra = [mx.nd.array(lengths, ctx=CPU)] \
        if attrs.get("use_sequence_length") else []
    with mx.autograd.record():
        outs = mx.nd.RNN(*nds, *extra, state_outputs=True, **attrs)
    cts = cotangents([o.shape for o in outs])
    mx.autograd.backward(outs, [mx.nd.array(c, ctx=CPU, dtype=dtype)
                                for c in cts])
    return ([o.asnumpy().astype(np.float32) for o in outs],
            [a.grad.asnumpy().astype(np.float32) for a in nds], cts)


def jax_run(arrays, lengths, attrs, cts, dtype=jnp.float32):
    attrs = {k: v for k, v in attrs.items() if k != "cudnn_off"}
    key = (repr(sorted(attrs.items())), str(dtype),
           tuple(a.tobytes() for a in arrays + cts))
    if key not in _JAX_RUNS:  # the routes of a case share the reference
        _JAX_RUNS[key] = _jax_run(arrays, lengths, attrs, cts, dtype)
    return _JAX_RUNS[key]


_JAX_RUNS = {}


def _jax_run(arrays, lengths, attrs, cts, dtype):
    kw = {"sequence_length": jnp.asarray(lengths)} \
        if attrs.get("use_sequence_length") else {}

    def f(*a):
        return jrnn._rnn(jax.random.PRNGKey(0), *a, state_outputs=True,
                         **kw, **attrs)

    # op by op: the scans' small steps run faster than a compile per case
    with jax.disable_jit():
        outs, vjp = jax.vjp(f, *[jnp.asarray(a, dtype) for a in arrays])
        grads = vjp(tuple(jnp.asarray(c, dtype) for c in cts))
    return ([np.asarray(o, np.float32) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


@pytest.mark.parametrize("mode,bidir,variant", CASES,
                         ids=[f"{m}-{'bi' if b else 'uni'}-{v}"
                              for m, b, v in CASES])
def test_rnn_op_matches_jax(mode, bidir, variant):
    attrs = dict(VARIANTS[variant] if variant in VARIANTS
                 else LSTM_VARIANTS[variant],
                 state_size=H, num_layers=L, mode=mode,
                 bidirectional=bidir)
    arrays, lengths = inputs(mode, bidir, attrs)
    route = trnn.rnn_route(**attrs)
    trnn.reset_routes()
    got, got_g, cts = port_run(arrays, lengths, attrs)
    assert trnn.ROUTE_CALLS == {"fused": int(route == "fused"),
                                "step": int(route == "step")}
    want, want_g = jax_run(arrays, lengths, attrs, cts)
    assert len(got) == len(want) == (3 if mode == "lstm" else 2)
    for name, g, w in zip(["output", "hT", "cT"], got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    for name, g, w in zip(["data", "parameters", "state", "state_cell"],
                          got_g, want_g):
        np.testing.assert_allclose(g, w, err_msg=f"grad {name}", **TOL)


def test_route_is_chosen_by_the_attributes_alone():
    assert trnn.rnn_route(mode="lstm") == "fused"
    assert trnn.rnn_route(mode="gru", bidirectional=True) == "fused"
    assert trnn.rnn_route(mode="lstm", projection_size=4) == "fused"
    assert trnn.rnn_route(mode="lstm", cudnn_off=True) == "step"
    assert trnn.rnn_route(mode="lstm", cudnn_off="False") == "fused"
    assert trnn.rnn_route(mode="gru", use_sequence_length=True) == "step"
    assert trnn.rnn_route(mode="lstm", lstm_state_clip_max=1.0) == "step"
    # shape inference on meta tensors computes no values and counts none
    trnn.reset_routes()
    shapes = treg.infer("RNN", ((T, N, I), "float32"),
                        ((trnn.rnn_param_size(L, H, I, "lstm"),), "float32"),
                        ((L, N, H), "float32"), ((L, N, H), "float32"),
                        state_size=H, num_layers=L, mode="lstm",
                        state_outputs=True)
    assert [s for s, _ in shapes] == [(T, N, H), (L, N, H), (L, N, H)]
    assert trnn.ROUTE_CALLS == {"fused": 0, "step": 0}


def test_bf16_runs_in_the_data_dtype_like_jax():
    """Both routes on bf16 inputs against the JAX op on the same values."""
    attrs = dict(state_size=H, num_layers=L, mode="lstm")
    arrays, lengths = inputs("lstm", False, attrs, seed=3)
    for cudnn_off in (False, True):
        got, _, cts = port_run(arrays, lengths, dict(attrs,
                                                     cudnn_off=cudnn_off),
                               dtype="bfloat16")
        if not cudnn_off:
            want, _ = jax_run(arrays, lengths, attrs, cts,
                              dtype=jnp.bfloat16)
        assert got[0].shape == want[0].shape
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-2)


def test_gru_h_side_bias_sits_inside_the_reset_gate():
    """n = tanh(W_in x + b_in + r * (W_hn h + b_hn)): with every weight zero
    but the h-side n bias, r = 1/2 and z = 1/2, one step from h0 = 0 gives
    h = (1 - 1/2) * tanh(b_hn / 2)."""
    n = trnn.rnn_param_size(1, 2, 3, "gru")
    w = np.zeros(n, np.float32)
    w[-2:] = [1.0, -2.0]  # the last of the flat vector: b_hn of h2h_bias
    x = np.zeros((1, 1, 3), np.float32)
    h0 = np.zeros((1, 1, 2), np.float32)
    for cudnn_off in (False, True):
        out = mx.nd.RNN(*[mx.nd.array(a, ctx=CPU) for a in (x, w, h0)],
                        state_size=2, mode="gru", cudnn_off=cudnn_off)
        np.testing.assert_allclose(out.asnumpy().reshape(-1),
                                   0.5 * np.tanh(np.array([0.5, -1.0])),
                                   rtol=1e-6)
    want = jrnn._rnn(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(w),
                     jnp.asarray(h0), state_size=2, mode="gru")
    np.testing.assert_allclose(np.asarray(want).reshape(-1),
                               0.5 * np.tanh(np.array([0.5, -1.0])),
                               rtol=1e-6)


@pytest.mark.parametrize("args", [
    (1, 8, 4, "lstm", False, None), (2, 8, 4, "gru", True, None),
    (3, 5, 7, "rnn_relu", False, None), (2, 8, 4, "lstm", True, 3),
    (1, 16, 16, "rnn_tanh", True, None)])
def test_rnn_param_size_matches_jax(args):
    assert trnn.rnn_param_size(*args) == jrnn.rnn_param_size(*args)


def test_rnn_param_concat_and_flat_gradient():
    rng = np.random.RandomState(0)
    parts = [rng.randn(*s).astype(np.float32) for s in ((4, 3), (4,), (2, 2))]
    nds = [mx.nd.array(p, ctx=CPU) for p in parts]
    for a in nds:
        a.attach_grad()
    with mx.autograd.record():
        flat = mx.nd._internal._rnn_param_concat(*nds, dim=0, num_args=3)
        (flat * mx.nd.arange(flat.shape[0], ctx=CPU)).sum().backward()
    want = np.asarray(jrnn._rnn_param_concat(*map(jnp.asarray, parts)))
    np.testing.assert_array_equal(flat.asnumpy(), want)
    offsets = np.cumsum([0] + [p.size for p in parts])
    for a, lo, p in zip(nds, offsets, parts):
        np.testing.assert_array_equal(
            a.grad.asnumpy(), np.arange(lo, lo + p.size,
                                        dtype=np.float32).reshape(p.shape))


def test_dropout_between_layers_only_in_training():
    """``p`` drops the outputs of every layer but the last, in training
    only: in prediction the op equals the JAX op's; in training, with p
    near 1, the second layer sees (almost) only zeros."""
    attrs = dict(state_size=H, num_layers=2, mode="lstm", p=0.999999)
    arrays, _ = inputs("lstm", False, attrs, seed=5)
    nds = [mx.nd.array(a, ctx=CPU) for a in arrays]
    predict = mx.nd.RNN(*nds, **attrs).asnumpy()
    with mx.autograd.train_mode():
        train = mx.nd.RNN(*nds, **attrs).asnumpy()
    want_predict = np.asarray(jrnn._rnn(
        jax.random.PRNGKey(0), *map(jnp.asarray, arrays),
        **{k: v for k, v in attrs.items() if k != "p"}))
    np.testing.assert_allclose(predict, want_predict, **TOL)
    assert not np.allclose(train, predict, atol=1e-3)
    assert np.isfinite(train).all()
