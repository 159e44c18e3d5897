"""The port's control flow held to the JAX package's on the CPU: the
imperative `mx.nd.contrib.foreach / while_loop / cond` (eager loops under
the port's autograd) and the symbolic `mx.sym.contrib` frontends (cut
subgraphs, free variables, `_foreach` / `_while_loop` / `_cond` nodes run
by the executor), with gradients, a JSON round trip of the symbol, a gluon
block with deferred parameters inside a body, and a `cond` whose branch not
taken is non-finite (the port selects between both branches on the device;
each branch's inputs pass a gradient gate, so that branch's NaN and
infinity stay out of every gradient, as `lax.cond`'s one branch does).
Outputs and gradients agree within rtol 1e-4 / atol 1e-5
(`tests/python/unittest/test_control_flow.py:55`).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = {"rtol": 1e-4, "atol": 1e-5}
RNG = np.random.RandomState(0)
X = RNG.randn(4, 3).astype(np.float32)
S0 = RNG.randn(3).astype(np.float32)
W = RNG.randn(3).astype(np.float32)


def _arrays(pkg, *values):
    kw = {"ctx": mx.cpu()} if pkg is mx else {}
    out = [pkg.nd.array(v, **kw) for v in values]
    for a in out:
        a.attach_grad()
    return out


def _ctx(pkg):
    return pkg.cpu()


# each program: (fn(pkg, x, s, w) -> list of NDArray outputs) whose sum is
# the loss
def _foreach(pkg, x, s, w):
    outs, states = pkg.nd.contrib.foreach(
        lambda d, st: (d * st[0] + w, [st[0] * 0.5 + d]), x, [s])
    return [outs, states[0]]


def _foreach_nested(pkg, x, s, w):
    def body(d, st):
        (d,), (a, (b,)) = d, st
        return [d * a, d + b], [a * 0.9 + d, [b - d * w]]

    (o1, o2), (a, (b,)) = pkg.nd.contrib.foreach(body, [x], [s, [w]])
    return [o1, o2, a, b]


def _while(pkg, x, s, w):
    i = pkg.nd.zeros((1,), ctx=_ctx(pkg))
    outs, (_, v) = pkg.nd.contrib.while_loop(
        lambda i, v: i < 3, lambda i, v: (v * 2 + w, [i + 1, v * w]),
        [i, s], max_iterations=5)
    return [outs, v]


def _while_nonfinite_past_stop(pkg, x, s, w, max_iterations=4):
    """Past the stop the body divides by zero."""
    i = pkg.nd.zeros((1,), ctx=_ctx(pkg))
    outs, (_, v) = pkg.nd.contrib.while_loop(
        lambda i, v: i < 2,
        lambda i, v: (v / (2 - i), [i + 1, v * w / (2 - i)]),
        [i, s], max_iterations=max_iterations)
    return [outs, v]


def _cond_then(pkg, x, s, w):
    return [pkg.nd.contrib.cond(s.sum() < 100, lambda: w * 3 + s,
                                lambda: pkg.nd.log(w - w))]


def _cond_else_nonfinite_untaken(pkg, x, s, w):
    return [pkg.nd.contrib.cond(s.sum() > 100, lambda: pkg.nd.log(w - w),
                                lambda: w * s)]


def _cond_tuple(pkg, x, s, w):
    a, b = pkg.nd.contrib.cond(w.sum() > 0, lambda: (w + 1, s * w),
                               lambda: (w - 1, s / (w * 0)))
    return [a, b]


ND_PROGRAMS = {f.__name__.lstrip("_"): f for f in (
    _foreach, _foreach_nested, _while, _cond_then,
    _cond_else_nonfinite_untaken, _cond_tuple)}


def _nd_run(pkg, program):
    x, s, w = _arrays(pkg, X, S0, W)
    with pkg.autograd.record():
        outs = program(pkg, x, s, w)
        loss = sum(o.sum() for o in outs)
    loss.backward()
    return ([o.asnumpy() for o in outs],
            [a.grad.asnumpy() for a in (x, s, w)])


@pytest.mark.parametrize("name", list(ND_PROGRAMS))
def test_nd_control_flow_matches_jax(name):
    got, got_g = _nd_run(mx, ND_PROGRAMS[name])
    want, want_g = _nd_run(jmx, ND_PROGRAMS[name])
    assert len(got) == len(want)
    for g, w in zip(got + got_g, want + want_g):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    for g in got_g:
        assert np.isfinite(g).all()


def test_nd_while_loop_masks_non_finite_steps_out_of_the_gradient():
    """The body divides by zero on the steps past the stop. Outputs equal
    the JAX package's (zero rows there); the gradients equal the JAX
    package's over exactly the active steps (``max_iterations=2``), where
    its own masked run lets the NaN of the masked steps through (it
    multiplies zero cotangents by infinite partials)."""
    got, got_g = _nd_run(mx, _while_nonfinite_past_stop)
    want, want_g = _nd_run(jmx, _while_nonfinite_past_stop)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert not all(np.isfinite(g).all() for g in want_g)
    _, exact_g = _nd_run(jmx, lambda *a: _while_nonfinite_past_stop(
        *a, max_iterations=2))
    for g, w in zip(got_g, exact_g):
        np.testing.assert_allclose(g, w, **TOL)


def test_nd_foreach_structure_and_no_record():
    """Outside `record()`, outputs keep the body's nesting and the states
    the init's."""
    def run(pkg):
        x, s, w = _arrays(pkg, X, S0, W)
        outs, states = pkg.nd.contrib.foreach(
            lambda d, st: ([d, [d * 2]], st), x, s)
        return outs, states

    (o1, (o2,)), st = run(mx)
    (j1, (j2,)), jst = run(jmx)
    for g, w in ((o1, j1), (o2, j2), (st, jst)):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


def test_nd_deferred_init_inside_a_body():
    """A Dense of unknown input width called in a foreach body: it
    initializes at the first step, from the same weights on both
    packages."""
    def run(pkg):
        dense = pkg.gluon.nn.Dense(2, in_units=0, use_bias=True)
        dense.initialize(pkg.init.Constant(0.3), ctx=_ctx(pkg))
        x, s, _ = _arrays(pkg, X, np.zeros((4, 2), np.float32), W)
        xs = x.reshape((4, 1, 3))
        with pkg.autograd.record():
            outs, _ = pkg.nd.contrib.foreach(
                lambda d, st: (dense(d) + st[0], st), xs, [s])
            loss = outs.sum()
        loss.backward()
        return outs.asnumpy(), dense.weight.grad().asnumpy()

    got, want = run(mx), run(jmx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


# -- symbolic ---------------------------------------------------------------

def _sym_programs(pkg):
    sym = pkg.sym

    def foreach(x, s, w):
        outs, st = sym.contrib.foreach(
            lambda d, st: (d * st[0] + w, [st[0] * 0.5 + d]), x, [s],
            name="fe")
        return [outs, st[0]]

    def while_loop(x, s, w):
        i = sym.zeros((1,))
        outs, (_, v) = sym.contrib.while_loop(
            lambda i, v: i < 3, lambda i, v: (v * 2 + w, [i + 1, v * w]),
            [i, s], max_iterations=5, name="wl")
        return [outs, v]

    def cond_nonfinite_untaken(x, s, w):
        return [sym.contrib.cond(sym.sum(s) > 100,
                                 lambda: sym.log(w - w) * sym.sum(x),
                                 lambda: w * s, name="cn")]

    def cond_then(x, s, w):
        return [sym.contrib.cond(sym.sum(s) < 100, lambda: w * 3 + s,
                                 lambda: sym.sqrt(w - w - 1), name="ct")]

    return {"foreach": foreach, "while_loop": while_loop,
            "cond_nonfinite_untaken": cond_nonfinite_untaken,
            "cond_then": cond_then}


def _sym_build(pkg, name):
    # the control-flow nodes are named explicitly: their default names
    # count per process, per package
    with pkg.name.NameManager():
        x, s, w = pkg.sym.var("x"), pkg.sym.var("s"), pkg.sym.var("w")
        return pkg.sym.Group(_sym_programs(pkg)[name](x, s, w))


def _sym_run(pkg, name, roundtrip):
    g = _sym_build(pkg, name)
    if roundtrip:
        g = pkg.sym.load_json(g.tojson())
    kw = {"ctx": mx.cpu()} if pkg is mx else {}
    feed = {k: v for k, v in (("x", X), ("s", S0), ("w", W))
            if k in g.list_arguments()}
    ex = g.simple_bind(**{k: v.shape for k, v in feed.items()}, **kw)
    ex.forward(is_train=True, **feed)
    ex.backward([pkg.nd.ones(o.shape, **kw) for o in ex.outputs])
    return ([o.asnumpy() for o in ex.outputs],
            [ex.grad_dict[k].asnumpy() for k in feed])


@pytest.mark.parametrize("roundtrip", [False, True],
                         ids=["built", "json_roundtrip"])
@pytest.mark.parametrize("name", ["foreach", "while_loop",
                                  "cond_nonfinite_untaken", "cond_then"])
def test_sym_control_flow_matches_jax(name, roundtrip):
    got, got_g = _sym_run(mx, name, roundtrip)
    want, want_g = _sym_run(jmx, name, roundtrip)
    for g, w in zip(got + got_g, want + want_g):
        np.testing.assert_allclose(g, w, **TOL)
    for g in got_g:
        assert np.isfinite(g).all()


@pytest.mark.parametrize("name", ["foreach", "while_loop", "cond_then"])
def test_sym_json_crosses_between_the_packages(name):
    """The port's graph text equals the JAX package's, and each package
    loads the other's and writes it back as the other does (a load parses
    the subgraph attributes, so the text written back differs from the
    first in both packages)."""
    port, ref = _sym_build(mx, name).tojson(), _sym_build(jmx, name).tojson()
    assert port == ref
    assert mx.sym.load_json(ref).tojson() == \
        jmx.sym.load_json(port).tojson()


def test_sym_free_variables_are_node_inputs():
    g = _sym_build(mx, "while_loop")
    assert g.list_arguments() == _sym_build(jmx, "while_loop") \
        .list_arguments()
    assert {"s", "w"} <= set(g.list_arguments())
