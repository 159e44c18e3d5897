"""The port's `gluon.rnn` and `gluon.contrib.rnn` held to the JAX package's
on the CPU, from the same numpy weights (by structural name) and inputs:
the cells unrolled (RNN, LSTM and GRU cells; NTC and TNC, merged or not,
masked by ``valid_length``; the sequential, residual, bidirectional,
zoneout and dropout cells; VariationalDropoutCell, LSTMPCell and the
convolutional cells), and the fused layers (RNN, LSTM, GRU: both layouts,
two layers, both directions, the LSTM projection, given and default begin
states, deferred ``input_size``, hybridized against the JAX package's
eager layer). Each run records a forward (in predict mode where a cell
draws random masks: the dropout, zoneout and variational cells are then
the identity, as in the reference) and takes the gradient of the outputs
times a fixed cotangent plus the final states: outputs, states and the
gradients of the inputs and every parameter agree within rtol 1e-4 /
atol 1e-5 (`tests/python/unittest/test_gluon_rnn.py:38-136`'s atol 1e-5).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import (gluon_params_from_numpy,
                                    rnn_arrays_to_flat, rnn_flat_to_arrays)

CPU = mx.cpu()
TOL = {"rtol": 1e-4, "atol": 1e-5}
T, N, C = 3, 2, 5


def _ctx(pkg):
    return CPU if pkg is mx else jmx.cpu()


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for item in x for y in _flat(item)]
    return [x]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _weights(ref):
    rng = np.random.RandomState(3)
    return {k: rng.uniform(-0.5, 0.5, p.shape).astype(np.float32)
            for k, p in sorted(ref._collect_params_with_prefix().items())}


def _run(pkg, block, call, arrays, train):
    """``call(pkg, block, *ndarrays)`` under record, then the backward of
    sum(out * ct) over its outputs and states: (outputs, gradients of the
    inputs and of every parameter), numpy."""
    ctx = _ctx(pkg)
    nds = [pkg.nd.array(a, ctx=ctx) for a in arrays]
    for a in nds:
        a.attach_grad()
    with pkg.autograd.record(train_mode=train):
        outs = _flat(call(pkg, block, *nds))
    rng = np.random.RandomState(5)
    cts = [pkg.nd.array(rng.standard_normal(o.shape).astype(np.float32),
                        ctx=ctx) for o in outs]
    pkg.autograd.backward(outs, cts)
    grads = {f"input {i}": a.grad.asnumpy() for i, a in enumerate(nds)}
    grads.update({k: p.grad().asnumpy() for k, p in
                  block._collect_params_with_prefix().items()})
    return [o.asnumpy() for o in outs], grads


def _hold(make, call, arrays, train=True, hybridize=False):
    """The block of ``make`` on both packages from the same weights; the
    JAX package's eager, the port's hybridized when asked."""
    ref = make(jmx)
    ref.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.autograd.predict_mode():
        call(jmx, ref, *[jmx.nd.array(a) for a in arrays])  # the shapes
    weights = _weights(ref)
    for k, p in ref._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    port = make(mx)
    gluon_params_from_numpy(port, weights, ctx=CPU)
    if hybridize:
        port.hybridize()
    got, got_g = _run(mx, port, call, arrays, train)
    want, want_g = _run(jmx, ref, call, arrays, train)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **TOL)
    return port


# -- cells ------------------------------------------------------------------

def _unroll(layout="NTC", merge=True, valid=False):
    def call(pkg, cell, x, *rest):
        if valid and pkg is jmx:
            return _jax_masked_unroll(cell, x, rest[0])
        kw = {"valid_length": rest[0]} if valid else {}
        return cell.unroll(T, x, layout=layout, merge_outputs=merge, **kw)
    return call


def _jax_masked_unroll(cell, x, valid):
    """The JAX package's ``unroll(valid_length=...)`` hangs on the CPU (its
    op cache's miss report compares the length array, an op attribute
    there, with ``==``, which dispatches an op under the cache's lock:
    ROADMAP.md, reference-side behaviour). Its semantics written out with
    the length as an input: the steps, then the outputs masked past each
    length and the states of each sequence's last valid step."""
    cell.reset()
    states = cell.begin_state(batch_size=x.shape[0])
    outs, all_states = [], []
    for t in range(T):
        out, states = cell(x[:, t], states)
        outs.append(out)
        all_states.append(states)
    last = [jmx.nd.SequenceLast(jmx.nd.stack(*s, axis=0), valid,
                                use_sequence_length=True, axis=0)
            for s in zip(*all_states)]
    return jmx.nd.SequenceMask(jmx.nd.stack(*outs, axis=1), valid,
                               use_sequence_length=True, axis=1), last


def _seq(kind, *cells):
    def make(p):
        net = getattr(p.gluon.rnn, kind)()
        for c in cells:
            net.add(c(p))
        return net
    return make


NTC = [_x(N, T, C)]
TNC = [_x(T, N, C)]
LENGTHS = np.array([3, 1], np.float32)
CELLS = {
    "rnn_cell_tanh": (lambda p: p.gluon.rnn.RNNCell(4), _unroll(), NTC,
                      True),
    "rnn_cell_relu_tnc": (lambda p: p.gluon.rnn.RNNCell(4, "relu"),
                          _unroll("TNC"), TNC, True),
    "lstm_cell": (lambda p: p.gluon.rnn.LSTMCell(4), _unroll(), NTC, True),
    "lstm_cell_unmerged": (lambda p: p.gluon.rnn.LSTMCell(4, input_size=C),
                           _unroll(merge=False), NTC, True),
    "lstm_cell_valid_length": (lambda p: p.gluon.rnn.LSTMCell(4),
                               _unroll(valid=True), NTC + [LENGTHS], True),
    "gru_cell": (lambda p: p.gluon.rnn.GRUCell(4), _unroll("TNC"), TNC,
                 True),
    "sequential": (_seq("SequentialRNNCell", lambda p: p.gluon.rnn.LSTMCell(4),
                        lambda p: p.gluon.rnn.GRUCell(3)), _unroll(), NTC,
                   True),
    "hybrid_sequential": (_seq("HybridSequentialRNNCell",
                               lambda p: p.gluon.rnn.RNNCell(3),
                               lambda p: p.gluon.rnn.LSTMCell(3)),
                          _unroll("TNC"), TNC, True),
    "residual": (lambda p: p.gluon.rnn.ResidualCell(p.gluon.rnn.GRUCell(C)),
                 _unroll(), NTC, True),
    "bidirectional": (lambda p: p.gluon.rnn.BidirectionalCell(
        p.gluon.rnn.LSTMCell(3), p.gluon.rnn.GRUCell(4)), _unroll(), NTC,
        True),
    "zoneout_predict": (lambda p: p.gluon.rnn.ZoneoutCell(
        p.gluon.rnn.LSTMCell(4), zoneout_outputs=0.5, zoneout_states=0.5),
        _unroll(), NTC, False),
    "zoneout_off": (lambda p: p.gluon.rnn.ZoneoutCell(p.gluon.rnn.GRUCell(4)),
                    _unroll(), NTC, True),
    "dropout_cell_predict": (_seq("SequentialRNNCell",
                                  lambda p: p.gluon.rnn.LSTMCell(4),
                                  lambda p: p.gluon.rnn.DropoutCell(0.5)),
                             _unroll(), NTC, False),
    "variational_dropout_predict": (
        lambda p: p.gluon.contrib.rnn.VariationalDropoutCell(
            p.gluon.rnn.LSTMCell(4), drop_inputs=0.3, drop_states=0.3,
            drop_outputs=0.3), _unroll(), NTC, False),
    "lstmp_cell": (lambda p: p.gluon.contrib.rnn.LSTMPCell(6, 3), _unroll(),
                   NTC, True),
    "conv1d_gru_cell": (lambda p: p.gluon.contrib.rnn.Conv1DGRUCell(
        (2, 6), 3, 3, 3, i2h_pad=1), _unroll(), [_x(N, T, 2, 6)], True),
    "conv2d_lstm_cell": (lambda p: p.gluon.contrib.rnn.Conv2DLSTMCell(
        (2, 4, 4), 2, 3, 3, i2h_pad=1), _unroll(), [_x(N, T, 2, 4, 4)],
        True),
    "conv3d_rnn_cell": (lambda p: p.gluon.contrib.rnn.Conv3DRNNCell(
        (1, 3, 3, 3), 2, 2, 3), _unroll(), [_x(N, T, 1, 3, 3, 3)], True),
}


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_unroll_matches_jax(name):
    make, call, arrays, train = CELLS[name]
    _hold(make, call, arrays, train=train)


def test_cell_step_by_step_and_begin_state():
    """``cell(x_t, states)`` one step at a time from `begin_state`, as the
    reference's examples drive a cell."""
    def call(pkg, cell, x):
        states = cell.begin_state(batch_size=N, ctx=_ctx(pkg))
        outs = []
        for t in range(T):
            out, states = cell(x[:, t], states)
            outs.append(out)
        return outs + states

    _hold(lambda p: p.gluon.rnn.LSTMCell(4), call, NTC)


def test_modified_cell_refuses_direct_use():
    base = mx.gluon.rnn.LSTMCell(4)
    mx.gluon.rnn.ZoneoutCell(base)
    with pytest.raises(AssertionError):
        base.begin_state(batch_size=1)


# -- fused layers -------------------------------------------------------------

def _layer_call(with_states, layout="TNC"):
    def call(pkg, layer, x):
        if not with_states:
            return layer(x)
        batch = x.shape[layout.find("N")]
        states = layer.begin_state(batch_size=batch, ctx=_ctx(pkg))
        return layer(x, states)
    return call


LAYERS = {
    "lstm_2layer_tnc_states": (
        lambda p: p.gluon.rnn.LSTM(4, num_layers=2), _layer_call(True),
        TNC),
    "lstm_bidirectional_ntc": (
        lambda p: p.gluon.rnn.LSTM(3, layout="NTC", bidirectional=True),
        _layer_call(True, "NTC"), NTC),
    "lstm_no_states_deferred": (
        lambda p: p.gluon.rnn.LSTM(4, num_layers=2, bidirectional=True),
        _layer_call(False), TNC),
    "lstm_projection": (
        lambda p: p.gluon.rnn.LSTM(6, num_layers=2, projection_size=3,
                                   input_size=C), _layer_call(True), TNC),
    "gru_2layer_bidirectional": (
        lambda p: p.gluon.rnn.GRU(4, num_layers=2, bidirectional=True,
                                  input_size=C), _layer_call(True), TNC),
    "rnn_relu_ntc": (lambda p: p.gluon.rnn.RNN(4, activation="relu",
                                               layout="NTC"),
                     _layer_call(True, "NTC"), NTC),
    "rnn_tanh_no_states": (lambda p: p.gluon.rnn.RNN(4, activation="tanh",
                                                     num_layers=2),
                           _layer_call(False), TNC),
}


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name, hybridize):
    make, call, arrays = LAYERS[name]
    port = _hold(make, call, arrays, hybridize=hybridize)
    if hybridize:
        assert port._cached_op is not None


def test_layer_parameter_names_and_state_info_match_jax():
    for make in (lambda p: p.gluon.rnn.LSTM(4, num_layers=2,
                                            bidirectional=True,
                                            projection_size=3),
                 lambda p: p.gluon.rnn.GRU(5, num_layers=3)):
        got, want = make(mx), make(jmx)
        assert [k[len(got.prefix):] for k in got.collect_params()] == \
            [k[len(want.prefix):] for k in want.collect_params()]
        assert got.state_info(7) == want.state_info(7)
        assert repr(got).replace(got.prefix, "") == \
            repr(want).replace(want.prefix, "")


def test_symbolic_flat_vector_loads_into_the_port_layer():
    """The converter: a symbolic LSTM's ``lstm_parameters_weight`` (the
    JAX package's fused op over the flat vector) split into the port's
    gluon layer computes the same outputs, and joins back bit for bit."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.ops import rnn as jrnn

    L, H = 2, 4
    n = jrnn.rnn_param_size(L, H, C, "lstm", True)
    flat = np.random.RandomState(8).uniform(-0.5, 0.5, n).astype(np.float32)
    x = TNC[0]
    h0 = np.zeros((2 * L, N, H), np.float32)
    want = jrnn._rnn(jax.random.PRNGKey(0), jnp.asarray(x),
                     jnp.asarray(flat), jnp.asarray(h0), jnp.asarray(h0),
                     state_size=H, num_layers=L, mode="lstm",
                     bidirectional=True)
    arrays = rnn_flat_to_arrays(flat, L, H, C, "lstm", bidirectional=True)
    layer = mx.gluon.rnn.LSTM(H, num_layers=L, bidirectional=True,
                              input_size=C)
    gluon_params_from_numpy(layer, arrays, ctx=CPU)
    got = layer(mx.nd.array(x, ctx=CPU))
    np.testing.assert_allclose(got.asnumpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        rnn_arrays_to_flat(arrays, L, bidirectional=True), flat)
