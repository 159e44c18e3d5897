"""The port's CTC loss (`mxnet_tpu_torch/ops/ctc.py`, gluon `CTCLoss`) held
to the JAX package's op and loss on the CPU, through the cases of
`tests/python/unittest/test_ctc.py`: blank first and last, given and
inferred lengths, an empty label, a single step, the gradient, the
Symbol path with an absent optional input, and a gluon training step.
Tolerances are the JAX package's (`mxnet_tpu/test_utils.py:142-160`): rtol
1e-4 / atol 1e-6 for fp32 values and gradients; the hand-checked cases at
the JAX test's own bounds.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

CPU = mx.cpu()
TOL = {"rtol": 1e-4, "atol": 1e-6}


def _both(fn_args, kwargs, grad=False, seed=5):
    """The CTC op on both packages: (loss, d loss . ct / d data) each."""
    out = []
    for pkg, ctx in ((mx, CPU), (jmx, jmx.cpu())):
        nds = [None if a is None else pkg.nd.array(a, ctx=ctx)
               for a in fn_args]
        if grad:
            nds[0].attach_grad()
            with pkg.autograd.record():
                loss = pkg.nd.ctc_loss(*nds, **kwargs)
            ct = np.random.RandomState(seed).uniform(0.5, 1.5, loss.shape)
            loss.backward(pkg.nd.array(ct.astype(np.float32), ctx=ctx))
            out.append((loss.asnumpy(), nds[0].grad.asnumpy()))
        else:
            out.append((pkg.nd.ctc_loss(*nds, **kwargs).asnumpy(), None))
    return out


def _blank_first_case():
    rng = np.random.RandomState(7)
    T, N, C, L = 15, 5, 7, 6
    data = rng.randn(T, N, C).astype(np.float32)
    lab_len = np.array([6, 4, 5, 1, 3], np.float32)
    dat_len = np.array([15, 12, 9, 7, 15], np.float32)
    labels = rng.randint(1, C, (N, L)).astype(np.float32)
    for i in range(N):
        labels[i, int(lab_len[i]):] = 0
    return data, labels, dat_len, lab_len


@pytest.mark.parametrize("grad", [False, True], ids=["value", "gradient"])
def test_blank_first_with_lengths(grad):
    data, labels, dat_len, lab_len = _blank_first_case()
    (got, g_got), (want, g_want) = _both(
        [data, labels, dat_len, lab_len],
        {"use_data_lengths": True, "use_label_lengths": True,
         "blank_label": "first"}, grad=grad)
    np.testing.assert_allclose(got, want, **TOL)
    if grad:
        np.testing.assert_allclose(g_got, g_want, **TOL)


@pytest.mark.parametrize("grad", [False, True], ids=["value", "gradient"])
def test_blank_last_inferred_lengths(grad):
    rng = np.random.RandomState(3)
    T, N, C, L = 10, 4, 5, 4
    data = rng.randn(T, N, C).astype(np.float32)
    labels = rng.randint(0, C - 1, (N, L)).astype(np.float32)
    for i, n in enumerate([4, 2, 3, 1]):
        labels[i, n:] = -1  # the padding value with blank_label="last"
    (got, g_got), (want, g_want) = _both([data, labels],
                                         {"blank_label": "last"}, grad=grad)
    np.testing.assert_allclose(got, want, **TOL)
    if grad:
        np.testing.assert_allclose(g_got, g_want, **TOL)


def test_single_step_and_empty_label():
    """The JAX test's hand-checked cases: one frame of a uniform softmax
    gives log 3; an all-padding label is the all-blank path."""
    with CPU:
        out = mx.nd.ctc_loss(mx.nd.zeros((1, 1, 3)), mx.nd.array([[1.0]]),
                             blank_label="first").asnumpy()
    np.testing.assert_allclose(out, [np.log(3.0)], rtol=1e-5, atol=1e-6)
    data = np.random.RandomState(1).randn(4, 1, 3).astype(np.float32)
    (got, _), (want, _) = _both([data, np.zeros((1, 2), np.float32)],
                                {"blank_label": "first"})
    lp = data - np.log(np.exp(data).sum(-1, keepdims=True))
    np.testing.assert_allclose(got, [-lp[:, 0, 0].sum()], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, want, **TOL)


def test_no_alignment_matches_the_jax_stand_in():
    """A label longer than the frames allow: the JAX op's large finite
    loss (its -1e30 stand-in for log 0) and its gradient, beside a padded
    row that has an alignment."""
    data = np.random.RandomState(4).randn(2, 2, 4).astype(np.float32)
    labels = np.array([[1, 1, 2], [3, 0, 0]], np.float32)
    (got, g_got), (want, g_want) = _both([data, labels], {}, grad=True)
    assert got[0] > 1e29 and np.isfinite(got[0])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(g_got, g_want, **TOL)


def test_symbol_with_an_absent_optional_input():
    """label lengths without data lengths bind by name through a Symbol
    graph and its JSON, and match the nd path and the JAX op."""
    rng = np.random.RandomState(2)
    T, N, C, L = 7, 3, 5, 3
    data = rng.randn(T, N, C).astype(np.float32)
    labels = rng.randint(0, C - 1, (N, L)).astype(np.float32)
    ll = np.array([3, 1, 2], np.float32)
    s = mx.gluon.loss.CTCLoss(layout="TNC")(
        mx.sym.var("pred"), mx.sym.var("label"), None, mx.sym.var("ll"))
    assert s.list_arguments() == ["pred", "label", "ll"]
    (ref, _), (want, _) = _both([data, labels, None, ll],
                                {"use_label_lengths": True,
                                 "blank_label": "last"})
    np.testing.assert_allclose(ref, want, **TOL)
    graph = mx.sym.ctc_loss(mx.sym.var("data"), mx.sym.var("label"), None,
                            mx.sym.var("ll"), use_label_lengths=True,
                            blank_label="last")
    for g in (graph, mx.sym.load_json(graph.tojson())):
        ex = g.simple_bind(CPU, data=(T, N, C), label=(N, L), ll=(N,))
        out = ex.forward(data=mx.nd.array(data, ctx=CPU),
                         label=mx.nd.array(labels, ctx=CPU),
                         ll=mx.nd.array(ll, ctx=CPU))[0].asnumpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lengths", ["none", "label_only", "both"])
def test_gluon_loss_matches_jax(lengths):
    rng = np.random.RandomState(5)
    N, T, C, L = 3, 6, 4, 3
    pred = rng.randn(N, T, C).astype(np.float32)
    label = np.array([[0, 1, 2], [2, -1, -1], [1, 1, -1]], np.float32)
    args = [pred, label]
    if lengths != "none":
        args += [np.array([6, 5, 4], np.float32) if lengths == "both"
                 else None, np.array([3, 1, 2], np.float32)]
    outs = []
    for pkg, ctx in ((mx, CPU), (jmx, jmx.cpu())):
        loss = pkg.gluon.loss.CTCLoss()
        x = pkg.nd.array(pred, ctx=ctx)
        x.attach_grad()
        nds = [x] + [None if a is None else pkg.nd.array(a, ctx=ctx)
                     for a in args[1:]]
        with pkg.autograd.record():
            out = loss(*nds)
        out.backward()
        outs.append((out.asnumpy(), x.grad.asnumpy()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, **TOL)


def test_gluon_training_step_matches_jax():
    """The JAX test's toy task (Dense over (N, T, 16), CTCLoss, Adam):
    from the same weights, each step's loss and the final weights agree,
    and the loss halves."""
    rng = np.random.RandomState(0)
    T, N, C = 8, 4, 5
    x = rng.randn(N, T, 16).astype(np.float32)
    labels = np.tile(np.array([[1.0, 2.0, -1.0]], np.float32), (N, 1))
    w0 = rng.uniform(-0.1, 0.1, (C, 16)).astype(np.float32)
    runs = []
    for pkg, ctx in ((mx, CPU), (jmx, jmx.cpu())):
        net = pkg.gluon.nn.Dense(C, flatten=False, in_units=16)
        net.initialize(ctx=ctx)
        net.weight.set_data(pkg.nd.array(w0, ctx=ctx))
        ctc = pkg.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.05})
        xs, ls = pkg.nd.array(x, ctx=ctx), pkg.nd.array(labels, ctx=ctx)
        losses = []
        for _ in range(25):
            with pkg.autograd.record():
                loss = ctc(net(xs), ls)
            loss.backward()
            trainer.step(N)
            losses.append(float(loss.mean().asnumpy()))
        runs.append((np.array(losses), net.weight.data().asnumpy()))
    (got, w), (want, jw) = runs
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(w, jw, **TOL)
    assert got[-1] < got[0] * 0.5
