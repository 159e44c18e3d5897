"""The instance pool of a hybridized block's `CachedOp`
(`mxnet_tpu_torch/_cached_op.py`), as far as it runs without a card.

On a card each instance of a signature is a pair of captured CUDA graphs
with their own static buffers: a replay overwrites the activations its
call's backward reads. Here a stand-in instance (`_Buffered`) keeps the
same contract on the CPU: each call copies its inputs into the
instance's own buffers, and its backward differentiates the function at
those buffers, which is what a backward graph's replay computes. The
pool, the autograd node, the holds and their release are the port's own.

The JAX package runs `example/gluon/dcgan.py`'s pattern (a hybridized
block called twice under one `record()` before `backward`); gradients are
held to its un-hybridized block's within rtol 1e-4 / atol 1e-6
(`mxnet_tpu/test_utils.py:142-160`).
"""
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _cached_op, autograd
from mxnet_tpu_torch.models import gluon_params_from_numpy

CPU = mx.cpu()
TOL = {"rtol": 1e-4, "atol": 1e-6}


class _Buffered:
    """A captured instance's contract on the CPU: the non-state inputs of
    each call live in this instance's buffers until its next call."""

    def __init__(self, fn, inputs, n_state, train, recording, owner=None):
        self.fn, self.n_state, self.train = fn, n_state, train
        self.generation, self.held = 0, False
        tensors = [a._data for a in inputs]
        self.state = tensors[:n_state]
        self.bufs = [t.detach().clone() for t in tensors[n_state:]]
        self.grad_ins = [t.requires_grad for t in tensors]
        outs = self._outputs(self._leaves())
        self.diff_outs = [i for i, o in enumerate(outs) if o.requires_grad]
        self.bwd_graph = object() if recording and self.diff_outs else None

    def _leaves(self):
        return [t.detach().requires_grad_(g) for t, g in
                zip(list(self.state) + self.bufs, self.grad_ins)]

    def _outputs(self, leaves):
        from mxnet_tpu_torch.ndarray.ndarray import NDArray

        # the function's writes into the state (moving stats) are a
        # forward's, not a backward's: put them back
        saved = [(t, t._version, t.detach().clone()) for t in self.state]
        # the recording flags alone: a new record() scope would drop the
        # caller's recorded leaves
        was = autograd.set_recording(True), autograd.set_training(self.train)
        try:
            with torch.enable_grad():
                outs = self.fn(*[NDArray(t) for t in leaves])
        finally:
            autograd.set_recording(was[0])
            autograd.set_training(was[1])
        with torch.no_grad():
            for t, version, s in saved:
                if t._version != version:
                    t.copy_(s)
        outs = [outs] if isinstance(outs, NDArray) else list(outs)
        return [o._data for o in outs]

    def forward(self, tensors):
        from mxnet_tpu_torch.ndarray.ndarray import NDArray

        self.state = tensors[:self.n_state]
        with torch.no_grad():
            for b, t in zip(self.bufs, tensors[self.n_state:]):
                b.copy_(t)
            with autograd._RecordingStateScope(False, self.train):
                outs = self.fn(*[NDArray(t) for t in
                                 list(self.state) + self.bufs])
        outs = [outs] if isinstance(outs, NDArray) else list(outs)
        return [o._data.detach().clone() for o in outs]

    def backward(self, generation, cts):
        assert generation == self.generation, "served a later call"
        leaves = self._leaves()
        outs = self._outputs(leaves)
        want = [i for i, t in enumerate(leaves) if t.requires_grad]
        grads = torch.autograd.grad([outs[i] for i in self.diff_outs],
                                    [leaves[i] for i in want],
                                    [cts[i] for i in self.diff_outs],
                                    allow_unused=True)
        by_input = dict(zip(want, grads))
        return tuple(by_input.get(i) for i in range(len(leaves)))


@pytest.fixture
def pooled(monkeypatch):
    """Hybridized blocks take the pool's path on the CPU."""
    monkeypatch.setattr(_cached_op, "_graphed", lambda t: True)
    monkeypatch.setattr(_cached_op, "_GraphProgram", _Buffered)


def _net(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="n_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(6, activation="relu"),
                pkg.gluon.nn.BatchNorm(), pkg.gluon.nn.Dense(3))
    return net


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"0.weight": rng.uniform(-1, 1, (6, 4)),
            "0.bias": rng.uniform(-1, 1, (6,)),
            "1.gamma": rng.uniform(0.5, 1.5, (6,)),
            "1.beta": rng.uniform(-1, 1, (6,)),
            "1.running_mean": rng.uniform(-0.1, 0.1, (6,)),
            "1.running_var": rng.uniform(0.5, 1.5, (6,)),
            "2.weight": rng.uniform(-1, 1, (3, 6)),
            "2.bias": rng.uniform(-1, 1, (3,))}


def _port_net(hybridize=True):
    net = _net(mx)
    gluon_params_from_numpy(net, {k: v.astype(np.float32)
                                  for k, v in _weights().items()}, ctx=CPU)
    if hybridize:
        net.hybridize()
    return net


def _batches(n=2):
    rng = np.random.RandomState(1)
    return [rng.uniform(-1, 1, (5, 4)).astype(np.float32) for _ in range(n)]


def _ct(seed=2):
    """A cotangent for an output of the net: BatchNorm in training makes
    the gradient of a plain sum nearly zero."""
    return np.random.RandomState(seed).standard_normal((5, 3)).astype(
        np.float32)


def _grads(net):
    return {k: p.grad().asnumpy().copy()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _pool(net):
    (pool,) = net._cached_op._cache.values()
    return pool


def test_a_second_recorded_call_takes_a_second_instance(pooled):
    net = _port_net()
    xs = [mx.nd.array(x, ctx=CPU) for x in _batches()]
    for it in range(3):
        with mx.autograd.record():
            y = net(xs[0]).sum() + net(xs[1]).sum()
        y.backward()
        # both calls pending at once: two instances; none after warm-up
        assert net._cached_op.captures == 2, it
        assert list(net._cached_op.instances().values()) == [2]
        assert not any(p.held for p in _pool(net).instances)
    with mx.autograd.record():
        first = net(xs[0])
    # a recorded call takes a free instance, the first one
    assert _pool(net).instances[0].held
    assert not _pool(net).instances[1].held
    first.backward()
    assert not _pool(net).instances[0].held


@pytest.mark.parametrize("order", ["first_then_second", "second_then_first"])
def test_each_pending_call_backpropagates_its_own_inputs(pooled, order):
    """Two calls under one record(), then each backward on its own: each
    gives its own call's gradients (the eager block's), in either
    order."""
    xs = _batches()
    want = []
    for x in xs:
        eager = _port_net(hybridize=False)
        with mx.autograd.record():
            out = eager(mx.nd.array(x, ctx=CPU))
        out.backward(mx.nd.array(_ct(), ctx=CPU))
        want.append(_grads(eager))
    net = _port_net()
    with mx.autograd.record():
        outs = [net(mx.nd.array(x, ctx=CPU)) for x in xs]
    order = [0, 1] if order == "first_then_second" else [1, 0]
    for k in order:
        # grad_req "write": each backward writes its own gradients;
        # the recorded leaves outlive a backward only when retained
        outs[k].backward(mx.nd.array(_ct(), ctx=CPU), retain_graph=True)
        got = _grads(net)
        for name in want[k]:
            np.testing.assert_allclose(got[name], want[k][name],
                                       err_msg=name, **TOL)


def test_dcgan_pattern_matches_the_jax_package(pooled):
    """The example's D step: the block on two batches inside one
    record(), one backward of the summed loss; gradients and moving stats
    against the JAX package's un-hybridized block."""
    xs = _batches()
    ref = _net(jmx)
    ref.initialize(ctx=jmx.cpu())
    ref(jmx.nd.array(xs[0]))
    for k, p in ref._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(_weights()[k].astype(np.float32)))
    c0, c1 = _ct(2), _ct(3)
    with jmx.autograd.record():
        y = (ref(jmx.nd.array(xs[0])) * jmx.nd.array(c0)).sum() + \
            (ref(jmx.nd.array(xs[1])) * jmx.nd.array(c1)).sum()
    y.backward()
    net = _port_net()
    with mx.autograd.record():
        z = (net(mx.nd.array(xs[0], ctx=CPU)) * mx.nd.array(c0, ctx=CPU)
             ).sum() + (net(mx.nd.array(xs[1], ctx=CPU))
                        * mx.nd.array(c1, ctx=CPU)).sum()
    z.backward()
    np.testing.assert_allclose(z.asnumpy(), y.asnumpy(), **TOL)
    got = _grads(net)
    for k, p in ref._collect_params_with_prefix().items():
        if p.grad_req != "null":
            np.testing.assert_allclose(got[k], p.grad().asnumpy(),
                                       err_msg=k, **TOL)
        else:
            np.testing.assert_allclose(
                net._collect_params_with_prefix()[k].data().asnumpy(),
                p.data().asnumpy(), err_msg=k, **TOL)


def test_a_dropped_output_frees_its_instance(pooled):
    net = _port_net()
    x = mx.nd.array(_batches()[0], ctx=CPU)
    for _ in range(4):
        with mx.autograd.record():
            out = net(x)
        assert _pool(net).instances[0].held
        del out  # never backpropagated: its node goes, and its hold
        gc.collect()
        assert not _pool(net).instances[0].held
    assert net._cached_op.captures == 1
    # an output kept alive keeps its instance: the next call captures
    with mx.autograd.record():
        kept = net(x)
        other = net(x)
    assert net._cached_op.captures == 2
    other.backward(retain_graph=True)
    kept.backward()
    assert not any(p.held for p in _pool(net).instances)


def test_calls_outside_recording_share_one_instance(pooled):
    net = _port_net()
    x = mx.nd.array(_batches()[0], ctx=CPU)
    with mx.autograd.record():
        held = net(x)
    outs = [net(x).asnumpy() for _ in range(3)]
    # recording is part of the signature: one recorded and one plain
    assert sorted(net._cached_op.instances().values()) == [1, 1]
    np.testing.assert_array_equal(outs[0], outs[2])
    held.backward()
