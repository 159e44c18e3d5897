"""The port's subgraph framework (`symbol/subgraph.py`), its ``TPU_FUSE``
backend (`symbol/fusion.py`) and the ops behind them
(`ops/subgraph_ops.py`) held to the JAX package's on the CPU.

Each graph of `tests/python/unittest/test_subgraph_quantization.py:58-331`
is built on both packages under a fresh `NameManager`: the rewritten
symbol's JSON text equals the JAX package's, character for character,
and its forward on the same weights matches the JAX package's rewritten
forward and the port's unrewritten one within that test's rtol 2e-4 /
atol 2e-5 (a fold reassociates the float arithmetic).
"""
import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.symbol.subgraph import (SubgraphProperty,
                                             SubgraphSelector,
                                             build_subgraph,
                                             list_subgraph_backends)

CPU = mx.cpu()
TOL = {"rtol": 2e-4, "atol": 2e-5}


def _conv_bn_relu(pkg):
    s = pkg.sym
    c = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=8,
                      name="conv0")
    b = s.BatchNorm(c, name="bn0", fix_gamma=False)
    r = s.Activation(b, act_type="relu", name="relu0")
    return s.FullyConnected(s.Flatten(r), num_hidden=4, name="fc0")


def _relu_spelling(pkg):
    s = pkg.sym
    c = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=8,
                      name="conv0", no_bias=True)
    b = s.BatchNorm(c, name="bn0", eps=1e-3)
    return s.FullyConnected(s.Flatten(s.relu(b, name="relu0")),
                            num_hidden=4, name="fc0")


def _no_relu(pkg):
    s = pkg.sym
    c = s.Convolution(s.Variable("data"), kernel=(1, 1), num_filter=4,
                      stride=(2, 2), name="conv0")
    return s.BatchNorm(c, name="bn0", fix_gamma=False)


def _shared_conv_output(pkg):
    s = pkg.sym
    c = s.Convolution(s.Variable("data"), kernel=(1, 1), num_filter=4,
                      name="conv0")
    return s.Group([s.BatchNorm(c, name="bn0", fix_gamma=False), c])


def _convexity(pkg):
    s = pkg.sym
    c = s.Convolution(s.Variable("data"), kernel=(1, 1), num_filter=4,
                      name="convX")
    benign = s.Activation(c, act_type="sigmoid", name="sig0")
    path = s.Activation(c, act_type="tanh", name="t0")
    b = s.BatchNorm(c, name="bnX", fix_gamma=False)
    return s.Group([benign, s.broadcast_add(b, path, name="mix")])


GRAPHS = {"conv_bn_relu": (_conv_bn_relu, 1),
          "relu_spelling": (_relu_spelling, 1),
          "no_relu": (_no_relu, 1),
          "shared_conv_output": (_shared_conv_output, 0),
          "convexity": (_convexity, 0)}


def _build(pkg, fn):
    with pkg.name.NameManager():
        return fn(pkg)


def _weights(sym, shapes, seed=0):
    """Arguments uniform on [-0.5, 0.5), aux states on [0.1, 1), from
    `RandomState(seed)`, as `test_subgraph_quantization.py` fills them."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    arg = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
           for n, s in zip(sym.list_arguments(), arg_shapes) if n != "data"}
    aux = {n: rng.uniform(0.1, 1.0, s).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return arg, aux


def _forward(pkg, sym, weights, x):
    """One inference forward of ``sym`` (either package) with ``weights``
    by name, whichever role the symbol gives them."""
    ctx = mx.cpu() if pkg is mx else jmx.cpu()
    with ctx:
        pool = {**weights[0], **weights[1]}
        args = {n: pkg.nd.array(pool[n]) for n in sym.list_arguments()
                if n != "data"}
        args["data"] = pkg.nd.array(x)
        aux = {n: pkg.nd.array(pool[n])
               for n in sym.list_auxiliary_states()}
        ex = sym.bind(ctx, args=args, aux_states=aux, grad_req="null")
        return [o.asnumpy() for o in ex.forward(is_train=False)]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tpu_fuse_matches_jax(name):
    fn, n_fused = GRAPHS[name]
    net, jnet = _build(mx, fn), _build(jmx, fn)
    with mx.name.NameManager():
        fused = net.get_backend_symbol("TPU_FUSE")
    with jmx.name.NameManager():
        jfused = jnet.get_backend_symbol("TPU_FUSE")
    assert fused.tojson() == jfused.tojson()
    ops = [n.op for n in fused._nodes() if n.op]
    assert ops.count("_fused_conv_bn_relu") == n_fused
    assert net.tojson() == jnet.tojson()  # the input symbol is untouched
    shape = (2, 3, 8, 8)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    weights = _weights(net, {"data": shape})
    got = _forward(mx, fused, weights, x)
    for want in (_forward(jmx, jfused, weights, x),
                 _forward(mx, net, weights, x)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("attrs", [
    {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4, "eps": 1e-3,
     "fix_gamma": False},
    {"kernel": (3, 3), "stride": (2, 2), "num_filter": 4,
     "fix_gamma": True, "with_relu": False},
    {"kernel": (1, 1), "num_filter": 4, "num_group": 2, "eps": 1e-5,
     "fix_gamma": False, "with_relu": True}])
def test_fused_conv_bn_relu_matches_jax_op(attrs):
    """The op against the JAX op on the same inputs, and against its
    definition: BatchNorm (moving stats) of the convolution, then ReLU."""
    rng = np.random.RandomState(0)
    group = attrs.get("num_group", 1)
    ins = [rng.uniform(-1, 1, (2, 4, 6, 6)),
           rng.uniform(-1, 1, (4, 4 // group) + attrs["kernel"]),
           rng.uniform(-1, 1, 4), rng.uniform(0.5, 1.5, 4),
           rng.uniform(-1, 1, 4), rng.uniform(-1, 1, 4),
           rng.uniform(0.5, 1.5, 4)]
    ins = [a.astype(np.float32) for a in ins]
    got = mx.nd.op._fused_conv_bn_relu(
        *[mx.nd.array(a, ctx=CPU) for a in ins], **attrs).asnumpy()
    want = jmx.nd.op._fused_conv_bn_relu(
        *[jmx.nd.array(a) for a in ins], **attrs).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    conv_attrs = {k: v for k, v in attrs.items()
                  if k in ("kernel", "stride", "pad", "num_filter",
                           "num_group")}
    conv = mx.nd.Convolution(*[mx.nd.array(a, ctx=CPU) for a in ins[:3]],
                             **conv_attrs)
    bn = mx.nd.BatchNorm(conv, *[mx.nd.array(a, ctx=CPU) for a in ins[3:]],
                         eps=attrs.get("eps", 1e-5),
                         fix_gamma=attrs["fix_gamma"]).asnumpy()
    if attrs.get("with_relu", True):
        bn = np.maximum(bn, 0)
    np.testing.assert_allclose(got, bn, **TOL)


class _TakeRelu(SubgraphSelector):
    def select(self, node):
        return node.op == "Activation"


class _Opaque(SubgraphProperty):
    def create_subgraph_selector(self):
        return _TakeRelu()


def test_default_property_makes_an_opaque_region_node():
    """The default `create_subgraph_node` wraps the region into one
    `_subgraph_exec` node, whose JSON is the JAX package's and whose
    forward (through the executor's graph function) is the region's."""
    from mxnet_tpu.symbol import subgraph as jsub

    class JTakeRelu(jsub.SubgraphSelector):
        def select(self, node):
            return node.op == "Activation"

    class JOpaque(jsub.SubgraphProperty):
        def create_subgraph_selector(self):
            return JTakeRelu()

    def net(pkg):
        s = pkg.sym
        return s.FullyConnected(s.Activation(s.Variable("data"),
                                             act_type="relu", name="a0"),
                                num_hidden=3, name="fc0")

    plain, jplain = _build(mx, net), _build(jmx, net)
    with mx.name.NameManager():
        wrapped = build_subgraph(plain, _Opaque())
    with jmx.name.NameManager():
        jwrapped = jsub.build_subgraph(jplain, JOpaque())
    assert wrapped.tojson() == jwrapped.tojson()
    ops = [n.op for n in wrapped._nodes() if n.op]
    assert "_subgraph_exec" in ops and "Activation" not in ops
    x = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    weights = _weights(plain, {"data": (4, 6)})
    got = _forward(mx, wrapped, weights, x)[0]
    np.testing.assert_allclose(got, _forward(jmx, jwrapped, weights, x)[0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _forward(mx, plain, weights, x)[0],
                               rtol=1e-5, atol=1e-6)
    # a JSON round trip keeps the region runnable
    again = mx.sym.load_json(wrapped.tojson())
    np.testing.assert_allclose(_forward(mx, again, weights, x)[0], got)


def test_backend_registry():
    assert "TPU_FUSE" in list_subgraph_backends()
    assert list_subgraph_backends() == [
        b for b in jmx.symbol.list_subgraph_backends() if b == "TPU_FUSE"]
    with pytest.raises(MXNetError, match="unknown subgraph backend"):
        mx.sym.Variable("x").get_backend_symbol("NOPE")


def test_env_backend_bind_with_explicit_args(monkeypatch):
    """The bind-time hook: with ``MXNET_SUBGRAPH_BACKEND=TPU_FUSE`` a
    `bind` given the unfused graph's args and aux states runs the folded
    graph, the moving stats moved into argument slots; on both packages
    the same outputs as the unfused bind."""
    shape = (1, 3, 8, 8)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    outs = {}
    for pkg in (mx, jmx):
        net = _build(pkg, _conv_bn_relu)
        weights = _weights(net, {"data": shape}, seed=5)
        ref = _forward(pkg, net, weights, x)[0]
        monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_FUSE")
        ctx = mx.cpu() if pkg is mx else jmx.cpu()
        with ctx:
            args = {k: pkg.nd.array(v) for k, v in weights[0].items()}
            args["data"] = pkg.nd.array(x)
            ex = net.bind(ctx, args=args, grad_req="null", aux_states={
                k: pkg.nd.array(v) for k, v in weights[1].items()})
            assert "bn0_moving_mean" in ex.arg_dict and not ex.aux_dict
            outs[pkg] = ex.forward(is_train=False)[0].asnumpy()
        monkeypatch.delenv("MXNET_SUBGRAPH_BACKEND")
        np.testing.assert_allclose(outs[pkg], ref, **TOL)
    np.testing.assert_allclose(outs[mx], outs[jmx], **TOL)


def test_small_resnet_export_folds_every_chain(tmp_path):
    """The serve phase's small ResNet v1, exported by the port: its nine
    Convolution -> BatchNorm chains fold into the same JSON text as the
    JAX package folds from the same file."""
    prefix = str(tmp_path / "small")
    cs.serve_small_export(mx, prefix)
    text = open(prefix + "-symbol.json").read()
    with mx.name.NameManager():
        fused = mx.sym.load_json(text).get_backend_symbol("TPU_FUSE")
    with jmx.name.NameManager():
        jfused = jmx.sym.load_json(text).get_backend_symbol("TPU_FUSE")
    assert fused.tojson() == jfused.tojson()
    ops = [n.op for n in fused._nodes() if n.op]
    assert ops.count("_fused_conv_bn_relu") == 9 and "BatchNorm" not in ops
