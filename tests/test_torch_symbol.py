"""The port's symbol (`mxnet_tpu_torch.symbol`: Symbol, the op namespace,
shape inference, JSON, the Executor) held to the JAX package's on the CPU,
from the same numpy inputs.

Names, shapes and JSON text must be equal. The Executor's outputs and
aux states are held within rtol 1e-5 / atol 1e-6 and its gradients within
rtol 1e-5 / atol 1e-5 (the convolution's bias gradient through BatchNorm
is float noise about 0), tighter than `test_symbol.py:133`'s atol 1e-4.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.models.resnet import resnet50_symbol as jresnet50
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.resnet import resnet50_symbol as presnet50

CPU = mx.cpu()
TOL = {"rtol": 1e-5, "atol": 1e-6}
GRAD_TOL = {"rtol": 1e-5, "atol": 1e-5}


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _conv_bn(pkg):
    data = pkg.sym.Variable("data")
    conv = pkg.sym.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                               name="conv")
    bn = pkg.sym.BatchNorm(conv, fix_gamma=False, momentum=0.8, name="bn")
    act = pkg.sym.Activation(bn, act_type="relu")
    pool = pkg.sym.Pooling(act, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
    flat = pkg.sym.Flatten(pool)
    return pkg.sym.FullyConnected(flat, num_hidden=3, name="fc")


def _resnet50(pkg):
    return (jresnet50 if pkg is jmx else presnet50)()


NETS = {"mlp": _mlp, "conv_bn": _conv_bn, "resnet50": _resnet50}


def _build(pkg, make):
    """``make(pkg)`` under a fresh name manager, so the auto-names
    (``pooling0``, ``flatten0``) start from 0 in both packages."""
    with pkg.name.NameManager():
        return make(pkg)


@pytest.mark.parametrize("net", list(NETS))
def test_name_lists_match_jax(net):
    got, want = _build(mx, NETS[net]), _build(jmx, NETS[net])
    assert got.list_arguments() == want.list_arguments()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()
    assert got.list_outputs() == want.list_outputs()
    assert got.list_inputs() == want.list_inputs()
    assert got.get_internals().list_outputs() == \
        want.get_internals().list_outputs()


@pytest.mark.parametrize("net", list(NETS))
def test_tojson_is_the_same_text(net):
    got, want = _build(mx, NETS[net]), _build(jmx, NETS[net])
    assert got.tojson() == want.tojson()
    assert got.debug_str() == want.debug_str()
    assert got.attr_dict() == want.attr_dict()


@pytest.mark.parametrize("net", list(NETS))
def test_json_crosses_packages(net):
    """A JSON from either package loads in the other and writes back the
    same text."""
    text = _build(jmx, NETS[net]).tojson()
    loaded = mx.sym.load_json(text)
    assert loaded.tojson() == text
    assert jmx.sym.load_json(loaded.tojson()).tojson() == text


def test_resnet50_infer_shape_matches_jax():
    shapes = {"data": (32, 3, 224, 224), "softmax_label": (32,)}
    got = _build(mx, _resnet50).infer_shape(**shapes)
    want = _build(jmx, _resnet50).infer_shape(**shapes)
    assert got == want
    arg_shapes, out_shapes, aux_shapes = got
    assert out_shapes == [(32, 1000)] and len(aux_shapes) == 2 * 51


def test_infer_shape_partial_and_errors_match_jax():
    for pkg in (mx, jmx):
        sym = _build(pkg, _mlp)
        with pytest.raises(pkg.base.MXNetError, match="softmax_label"):
            sym.infer_shape(data=(8, 10))
    got = _build(mx, _mlp).infer_shape_partial(data=(8, 10))
    want = _build(jmx, _mlp).infer_shape_partial(data=(8, 10))
    assert got == want
    assert got[0][-1] is None  # the label stays unknown
    assert _build(mx, _mlp).infer_type(data="float32") == \
        _build(jmx, _mlp).infer_type(data="float32")


def test_variable_attrs_and_scope_match_jax():
    def build(pkg):
        with pkg.AttrScope(ctx_group="dev1"):
            w = pkg.sym.var("w", shape=(4, 3), lr_mult=2.0, wd_mult=0.0,
                            dtype="float16", init=pkg.init.Xavier())
        x = pkg.sym.var("x")
        y = pkg.sym.FullyConnected(x, w, num_hidden=4, no_bias=True,
                                   name="fc")
        return w, y

    (pw, py), (jw, jy) = build(mx), build(jmx)
    assert pw.list_attr() == jw.list_attr()
    assert pw.attr("__lr_mult__") == jw.attr("__lr_mult__") == "2.0"
    assert py.tojson() == jy.tojson()
    assert py.list_arguments() == ["x", "w"]


@pytest.mark.parametrize("expr", [
    lambda a, b: a + b, lambda a, b: a - 2.0, lambda a, b: 3.0 - a,
    lambda a, b: a * b, lambda a, b: a / 4.0, lambda a, b: 2.0 / b,
    lambda a, b: -a, lambda a, b: a ** 2.0, lambda a, b: a > b,
], ids=["add", "sub", "rsub", "mul", "div", "rdiv", "neg", "pow", "gt"])
def test_arithmetic_matches_jax(expr):
    rng = np.random.RandomState(0)
    a, b = rng.uniform(0.5, 2.0, (2, 3)).astype(np.float32), \
        rng.uniform(0.5, 2.0, (2, 3)).astype(np.float32)

    def run(pkg, ctx):
        with pkg.name.NameManager():
            sym = expr(pkg.sym.var("a"), pkg.sym.var("b"))
        kw = {n: pkg.nd.array(v, ctx=ctx) for n, v in (("a", a), ("b", b))
              if n in sym.list_arguments()}
        return sym.tojson(), sym.eval(ctx, **kw)[0].asnumpy()

    (pj, pv), (jj, jv) = run(mx, CPU), run(jmx, jmx.cpu())
    assert pj == jj
    np.testing.assert_allclose(pv, jv, **TOL)


def test_group_getitem_and_children_match_jax():
    def build(pkg):
        with pkg.name.NameManager():
            a = pkg.sym.var("a")
            g = pkg.sym.Group([a * 2.0, a + 1.0])
        return g

    got, want = build(mx), build(jmx)
    assert len(got) == len(want) == 2
    assert got.list_outputs() == want.list_outputs()
    assert got[1].name == want[1].name
    assert got[got.list_outputs()[0]].name == want[0].name
    assert got[0].get_children().list_outputs() == \
        want[0].get_children().list_outputs()
    outs = got.bind(CPU, args={"a": mx.nd.ones((2,), ctx=CPU)}).forward()
    np.testing.assert_allclose(outs[0].asnumpy(), [2, 2])
    np.testing.assert_allclose(outs[1].asnumpy(), [2, 2])


def _conv_bn_arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.uniform(-1, 1, (2, 3, 6, 6)).astype(np.float32),
            "conv_weight": rng.normal(0, 0.3, (4, 3, 3, 3)).astype(
                np.float32),
            "conv_bias": rng.normal(0, 0.1, (4,)).astype(np.float32),
            "bn_gamma": rng.uniform(0.5, 1.5, (4,)).astype(np.float32),
            "bn_beta": rng.normal(0, 0.1, (4,)).astype(np.float32),
            "fc_weight": rng.normal(0, 0.3, (3, 36)).astype(np.float32),
            "fc_bias": rng.normal(0, 0.1, (3,)).astype(np.float32)}, {
            "bn_moving_mean": rng.normal(0, 0.1, (4,)).astype(np.float32),
            "bn_moving_var": rng.uniform(0.5, 1.5, (4,)).astype(np.float32)}


def _executor_run(pkg, ctx, grad_req, is_train, steps):
    """Bind the conv + BN net to fixed arrays, run ``steps`` forward and
    backward passes with a fixed cotangent; the outputs, the gradients
    and the aux states, as numpy."""
    args, auxs = _conv_bn_arrays()
    sym = _build(pkg, _conv_bn)
    names = sym.list_arguments()
    req = {n: ("null" if n == "data" else grad_req) for n in names}
    ex = sym.bind(ctx, args={k: pkg.nd.array(v, ctx=ctx)
                             for k, v in args.items()},
                  args_grad={n: pkg.nd.zeros(args[n].shape, ctx=ctx)
                             for n in names if req[n] != "null"},
                  grad_req=req,
                  aux_states={k: pkg.nd.array(v, ctx=ctx)
                              for k, v in auxs.items()})
    cot = np.random.RandomState(1).normal(0, 1, (2, 3)).astype(np.float32)
    for _ in range(steps):
        out = ex.forward(is_train=is_train)[0].asnumpy()
        if is_train and grad_req != "null":
            ex.backward(pkg.nd.array(cot, ctx=ctx))
    return (out, {n: g.asnumpy() for n, g in ex.grad_dict.items()
                  if g is not None},
            {n: a.asnumpy() for n, a in ex.aux_dict.items()})


@pytest.mark.parametrize("grad_req,is_train,steps", [
    ("write", True, 1), ("write", True, 2), ("add", True, 2),
    ("null", True, 1), ("write", False, 1)])
def test_executor_forward_backward_matches_jax(grad_req, is_train, steps):
    got = _executor_run(mx, CPU, grad_req, is_train, steps)
    want = _executor_run(jmx, jmx.cpu(), grad_req, is_train, steps)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert sorted(got[1]) == sorted(want[1])
    for k, v in got[1].items():
        np.testing.assert_allclose(v, want[1][k], err_msg=k, **GRAD_TOL)
    for k, v in got[2].items():
        np.testing.assert_allclose(v, want[2][k], err_msg=k, **TOL)
    init = _conv_bn_arrays()[1]
    moved = not np.allclose(got[2]["bn_moving_mean"], init["bn_moving_mean"])
    assert moved == is_train  # aux states move only when training
    if grad_req == "add":
        once = _executor_run(mx, CPU, "write", True, 1)[1]
        for k, v in got[1].items():
            np.testing.assert_allclose(v, 2 * once[k], err_msg=k,
                                       **GRAD_TOL)


def test_simple_bind_and_set_args_write_in_place():
    sym = _build(mx, _mlp)
    ex = sym.simple_bind(CPU, data=(8, 10), softmax_label=(8,))
    assert ex.arg_dict["fc1_weight"].shape == (16, 10)
    assert sorted(ex.grad_dict) == sorted(sym.list_arguments())
    bound = ex.arg_dict["data"]._data
    ex.set_args(data=np.ones((8, 10), np.float32))
    assert ex.arg_dict["data"]._data is bound  # a copy, not a rebind
    np.testing.assert_array_equal(bound.numpy(), 1.0)
    assert sorted(ex.output_dict) == ["softmax_output"] or \
        ex.output_dict == {}
    with pytest.raises(MXNetError, match="backward requires"):
        ex.backward()


def test_executor_reshape_keeps_parameters():
    sym = _build(mx, _mlp)
    ex = sym.simple_bind(CPU, data=(8, 10), softmax_label=(8,))
    new = ex.reshape(data=(3, 10), softmax_label=(3,))
    assert new.arg_dict["data"].shape == (3, 10)
    assert new.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    out = new.forward(data=np.ones((3, 10), np.float32),
                      softmax_label=np.zeros(3, np.float32))
    assert out[0].shape == (3, 4)


def test_monitor_sees_every_output():
    sym = _build(mx, _mlp)
    ex = sym.simple_bind(CPU, data=(4, 10), softmax_label=(4,))
    mon = mx.monitor.Monitor(1)
    mon.install(ex)
    mon.tic()
    ex.forward(data=np.ones((4, 10), np.float32))
    stats = mon.toc()
    assert [name for _, name, _ in stats] == ["softmax_output"]


def test_without_a_card_binding_needs_the_cpu():
    sym = _build(mx, _mlp)
    if mx.num_gpus():
        pytest.fail("this test expects a machine without a CUDA card")
    with pytest.raises(MXNetError, match="no CUDA device"):
        sym.simple_bind(data=(8, 10), softmax_label=(8,))
    args = {n: mx.nd.zeros((1,), ctx=CPU) for n in sym.list_arguments()}
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.sym.Executor(sym, None, args=args)
    with CPU:
        assert sym.simple_bind(data=(8, 10), softmax_label=(8,)) \
            ._device.type == "cpu"


def test_subgraph_backend_variable_raises(monkeypatch):
    """`MXNET_SUBGRAPH_BACKEND` no longer raises: a registered backend
    rewrites the graph at bind time, an unknown one (or NONE) leaves it as
    it is, as in the JAX package (`subgraph.py:323-331`)."""
    with mx.name.NameManager():
        conv = mx.sym.Convolution(mx.sym.var("data"), kernel=(3, 3),
                                  num_filter=4, name="conv")
        sym = mx.sym.BatchNorm(conv, name="bn")

    def ops(backend):
        monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", backend)
        ex = sym.simple_bind(CPU, data=(2, 3, 6, 6))
        return {n.op for n in ex._symbol._nodes() if n.op}

    assert "_fused_conv_bn_relu" in ops("TPU_FUSE")
    assert "BatchNorm" not in ops("TPU_FUSE")
    assert "BatchNorm" in ops("NO_SUCH_BACKEND")
    assert "BatchNorm" in ops("NONE")


def test_unknown_argument_and_grouped_input_raise():
    with pytest.raises(MXNetError, match="unknown argument"):
        mx.sym.FullyConnected(mx.sym.var("x"), num_hiden=3)
    g = mx.sym.Group([mx.sym.var("a"), mx.sym.var("b")])
    with pytest.raises(MXNetError, match="grouped symbol"):
        mx.sym.FullyConnected(g, num_hidden=3)


def test_asnumpy_is_a_copy_of_an_array_written_in_place():
    """`asnumpy` returns a copy, as in the JAX package: a BatchNorm's
    moving mean is written in place by the op (`mutate_aux`), and the
    executor's bound arrays by `set_args`; a host copy taken before must
    keep its values."""
    with CPU:
        x = mx.nd.array(np.random.RandomState(0).randn(4, 3).astype(
            np.float32))
        gamma, beta = mx.nd.ones((3,)), mx.nd.zeros((3,))
        mean, var = mx.nd.zeros((3,)), mx.nd.ones((3,))
        before = mean.asnumpy()
        with mx.autograd.record():
            mx.nd.BatchNorm(x, gamma, beta, mean, var)
        assert np.abs(mean.asnumpy()).max() > 0
        np.testing.assert_array_equal(before, 0.0)
    ex = _build(mx, _mlp).simple_bind(CPU, data=(2, 3), softmax_label=(2,))
    host = ex.arg_dict["data"].asnumpy()
    ex.set_args(data=np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(host, 0.0)
