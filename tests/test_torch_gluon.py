"""The port's gluon path (`mxnet_tpu_torch.gluon`, `initializer`, `name`,
`io`, `metric`, `lr_scheduler`) held to the JAX package's on the CPU, with
the same numpy inputs and weights on both sides.

Tolerances: a layer's or loss's outputs and gradients (of the sum of the
outputs times a fixed cotangent) within rtol 1e-4 / atol 1e-6, the JAX
package's `assert_almost_equal` bounds (`mxnet_tpu/test_utils.py:142-160`);
a hybridized block against the eager one within atol 1e-6
(`test_hybrid_matches_eager`, `tests/python/unittest/test_gluon.py:85-98`);
random initializers by their moments and bounds (the streams are torch's,
not numpy's); iterators, metrics and schedules exactly or to float
rounding.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import gluon_params_from_numpy

CPU = mx.cpu()
TOL = {"rtol": 1e-4, "atol": 1e-6}


def _np(x):
    return np.asarray(x.asnumpy(), np.float32)


# -- name, initializer -------------------------------------------------------

def test_name_manager_and_prefix_match_jax():
    def names(pkg):
        with pkg.name.Prefix("net_"):
            a = pkg.name.current().get(None, "dense")
            b = pkg.name.current().get(None, "dense")
            c = pkg.name.current().get("given", "dense")
        with pkg.name.NameManager():
            d = pkg.name.current().get(None, "conv")
        return a, b, c, d

    assert names(mx) == names(jmx) == ("net_dense0", "net_dense1",
                                       "net_given", "conv0")


def _init(pkg, init, shape, name="w_weight"):
    arr = pkg.nd.zeros(shape) if pkg is jmx else pkg.nd.zeros(shape, ctx=CPU)
    init(pkg.init.InitDesc(name), arr)
    return _np(arr)


# (initializer, shape, the bound of |value| or None): draws compared by
# their mean and standard deviation, within 5 standard errors
RANDOM_INITS = {
    "uniform": (lambda p: p.init.Uniform(0.07), (256, 512), 0.07),
    "normal": (lambda p: p.init.Normal(0.02), (256, 512), None),
    "xavier": (lambda p: p.init.Xavier(), (64, 32, 3, 3),
               np.sqrt(3.0 / ((64 + 32) * 9 / 2.0))),
    "xavier_gaussian_in": (lambda p: p.init.Xavier("gaussian", "in", 2),
                           (128, 256), None),
    "xavier_out": (lambda p: p.init.Xavier(factor_type="out"), (128, 256),
                   np.sqrt(3.0 / 128)),
    "msraprelu": (lambda p: p.init.MSRAPrelu(), (64, 32, 3, 3), None),
}


@pytest.mark.parametrize("name", list(RANDOM_INITS))
def test_random_initializer_moments_match_jax(name):
    make, shape, bound = RANDOM_INITS[name]
    got, want = _init(mx, make(mx), shape), _init(jmx, make(jmx), shape)
    n = got.size
    assert got.shape == want.shape and got.dtype == want.dtype
    sd = want.std()
    assert abs(got.mean() - want.mean()) < 5 * sd / np.sqrt(n / 2)
    assert abs(got.std() - sd) < 5 * sd / np.sqrt(n / 2)
    if bound is not None:
        assert np.abs(got).max() <= bound
    assert not np.array_equal(got, _init(mx, make(mx), shape))  # draws move


def test_deterministic_initializers_match_jax_exactly():
    cases = [(lambda p: p.init.Zero(), (3, 4)),
             (lambda p: p.init.One(), (3, 4)),
             (lambda p: p.init.Constant(0.3), (3, 4)),
             (lambda p: p.init.Bilinear(), (2, 1, 4, 4)),
             (lambda p: p.init.LSTMBias(2.0), (16,)),
             (lambda p: p.init.create("zeros"), (5,)),
             (lambda p: p.init.create('["constant", {"value": 2.5}]'), (2,))]
    for make, shape in cases:
        np.testing.assert_array_equal(_init(mx, make(mx), shape),
                                      _init(jmx, make(jmx), shape))
    # the suffix rule: bias, gamma, beta and moving stats
    for name in ("fc_bias", "bn_gamma", "bn_beta", "bn_running_mean",
                 "bn_running_var", "bn_moving_var"):
        np.testing.assert_array_equal(
            _init(mx, mx.init.Xavier(), (4,), name),
            _init(jmx, jmx.init.Xavier(), (4,), name))
    with pytest.raises(mx.MXNetError, match="Unknown initialization"):
        _init(mx, mx.init.Xavier(), (4,), "transitions")


def test_orthogonal_load_mixed_and_attr_init():
    q = _init(mx, mx.init.Orthogonal(scale=1.0), (8, 16))
    np.testing.assert_allclose(q @ q.T, np.eye(8), atol=1e-5)
    src = {"arg:a_weight": np.full((2, 3), 7.0, np.float32)}
    load = mx.init.Load(src, default_init=mx.init.One())
    np.testing.assert_array_equal(_init(mx, load, (2, 3), "a_weight"), 7.0)
    np.testing.assert_array_equal(_init(mx, load, (2,), "b_weight"), 1.0)
    mixed = mx.init.Mixed(["first.*", ".*"],
                          [mx.init.Constant(2.0), mx.init.One()])
    np.testing.assert_array_equal(_init(mx, mixed, (2,), "first_weight"), 2.0)
    np.testing.assert_array_equal(_init(mx, mixed, (2,), "c_weight"), 1.0)
    # a parameter's own initializer rides the InitDesc and beats the suffix
    desc = mx.init.InitDesc("d_bias",
                            {"__init__": mx.init.Constant(5.0).dumps()})
    arr = mx.nd.zeros((3,), ctx=CPU)
    mx.init.Xavier()(desc, arr)
    np.testing.assert_array_equal(_np(arr), 5.0)


# -- Parameter, ParameterDict ----------------------------------------------

def test_parameter_lifecycle():
    p = mx.gluon.Parameter("weight", shape=(10, 10))
    with pytest.raises(RuntimeError):
        p.data()
    p.initialize(init="xavier", ctx=[CPU])
    assert len(p.list_data()) == len(p.list_grad()) == 1
    assert p.data(CPU).shape == p.grad(CPU).shape == (10, 10)
    assert p.data()._data.requires_grad
    t = p.data()._data
    p.set_data(np.ones((10, 10), np.float32))  # in place
    assert p.data()._data is t and np.all(_np(p.data()) == 1.0)
    p.grad()._data.fill_(3.0)
    p.zero_grad()
    assert np.all(_np(p.grad()) == 0.0)
    p.cast("float16")
    assert p.data().dtype == np.float16 and p.grad().dtype == np.float16
    p.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        p.grad()
    assert not p.data()._data.requires_grad
    d = mx.gluon.Parameter("d", shape=(0, 3), allow_deferred_init=True)
    d.initialize(ctx=CPU)
    with pytest.raises(mx.gluon.DeferredInitializationError):
        d.data()
    # sparse storage is ported (slice 15): the stype is kept, the weight
    # is dense and the gradient buffer row-sparse
    s = mx.gluon.Parameter("s_weight", shape=(2, 3), stype="row_sparse",
                           grad_stype="row_sparse")
    s.initialize(ctx=CPU)
    assert s.stype == "row_sparse" and s.data().stype == "default"
    assert s.grad().stype == "row_sparse"
    c = mx.gluon.Constant("c", np.arange(3, dtype=np.float32))
    c.initialize(ctx=CPU)
    np.testing.assert_array_equal(_np(c.data()), np.arange(3))
    assert c.grad_req == "null"


def test_parameter_dict_save_load_crosses_packages(tmp_path):
    def make(pkg):
        params = pkg.gluon.ParameterDict("net_")
        params.get("weight", shape=(4, 3))
        params.get("bias", shape=(4,), lr_mult=2.0)
        return params

    port, ref = make(mx), make(jmx)
    assert list(port.keys()) == list(ref.keys()) == ["net_weight", "net_bias"]
    assert port["net_bias"].lr_mult == 2.0
    with pytest.raises(AssertionError):
        port.get("weight", shape=(4, 3), dtype="float16")
    ref.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    f = str(tmp_path / "ref.params")
    ref.save(f)
    jmx.nd.load(f)  # waits for the JAX package's writer
    port.load(f, ctx=CPU)
    for k in ref.keys():
        np.testing.assert_array_equal(_np(port[k].data()), _np(ref[k].data()))
    f2 = str(tmp_path / "port.params")
    port.save(f2, strip_prefix="net_")
    back = make(jmx)
    back.load(f2, jmx.cpu(), restore_prefix="net_")
    for k in ref.keys():
        np.testing.assert_array_equal(_np(back[k].data()), _np(ref[k].data()))


# -- layers -------------------------------------------------------------------

def _run(pkg, block, inputs, ct_seed=5):
    """Forward under record (train mode) and backward of sum(out * ct): the
    outputs and the gradients of every input and parameter, numpy."""
    ctx = CPU if pkg is mx else jmx.cpu()
    nds = [pkg.nd.array(a, ctx=ctx, dtype=a.dtype) for a in inputs]
    for x in nds:
        if x.dtype == np.float32:
            x.attach_grad()
    with pkg.autograd.record():
        out = block(*nds)
    outs = out if isinstance(out, (list, tuple)) else [out]
    rng = np.random.RandomState(ct_seed)
    cts = [pkg.nd.array(rng.standard_normal(o.shape).astype(np.float32),
                        ctx=ctx) for o in outs]
    pkg.autograd.backward(outs, cts)
    grads = {f"input {i}": _np(x.grad) for i, x in enumerate(nds)
             if x.dtype == np.float32}
    params = block._collect_params_with_prefix()
    grads.update({k: _np(p.grad()) for k, p in params.items()
                  if p.grad_req != "null"})
    state = {k: _np(p.data()) for k, p in params.items()}
    return [_np(o) for o in outs], grads, state


def _hold(make, inputs, hybridize=False, ref_hybridize=False):
    """Run a block on both packages from the same weights; compare
    outputs, gradients and parameters after (BatchNorm's moving stats)."""
    ref = make(jmx)
    ref.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    ref(*[jmx.nd.array(a, dtype=a.dtype) for a in inputs])  # shapes
    rng = np.random.RandomState(3)
    weights = {k: rng.uniform(-1, 1, p.shape).astype(np.float32)
               for k, p in ref._collect_params_with_prefix().items()}
    for k, p in ref._collect_params_with_prefix().items():
        if k.endswith("running_var"):
            weights[k] = np.abs(weights[k]) + 0.5
        p.set_data(jmx.nd.array(weights[k]))
    port = make(mx)
    gluon_params_from_numpy(port, weights, ctx=CPU)
    if hybridize:
        port.hybridize()
    if ref_hybridize:
        ref.hybridize()
    got, want = _run(mx, port, inputs), _run(jmx, ref, inputs)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, **TOL)
    for part in (1, 2):
        assert sorted(got[part]) == sorted(want[part])
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       err_msg=k, **TOL)
    return got


def _u(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


LAYERS = {
    "dense": (lambda p: p.gluon.nn.Dense(5, activation="tanh"), [_u(2, 3, 4)]),
    "dense_noflatten": (lambda p: p.gluon.nn.Dense(5, flatten=False,
                                                   use_bias=False),
                        [_u(2, 3, 4)]),
    "dropout_predict": (lambda p: p.gluon.nn.Dropout(0.0), [_u(3, 4)]),
    "embedding": (lambda p: p.gluon.nn.Embedding(10, 4, sparse_grad=True),
                  [np.array([[1, 3], [9, 3]], np.float32)]),
    "batchnorm": (lambda p: p.gluon.nn.BatchNorm(), [_u(4, 3, 2, 2)]),
    "batchnorm_fixgamma_axis": (
        lambda p: p.gluon.nn.BatchNorm(axis=-1, scale=False, momentum=0.5),
        [_u(4, 2, 3)]),
    "layernorm": (lambda p: p.gluon.nn.LayerNorm(), [_u(3, 5)]),
    "flatten": (lambda p: p.gluon.nn.Flatten(), [_u(2, 3, 2)]),
    "conv1d": (lambda p: p.gluon.nn.Conv1D(4, 3, strides=2, padding=1),
               [_u(2, 3, 9)]),
    "conv2d_groups": (lambda p: p.gluon.nn.Conv2D(4, (3, 2), groups=2,
                                                  dilation=2, padding=1),
                      [_u(2, 4, 7, 6)]),
    "conv3d": (lambda p: p.gluon.nn.Conv3D(2, 2, use_bias=False,
                                           activation="relu"),
               [_u(1, 2, 4, 4, 4)]),
    "maxpool1d": (lambda p: p.gluon.nn.MaxPool1D(3, 2, 1), [_u(2, 2, 9)]),
    "maxpool2d_ceil": (lambda p: p.gluon.nn.MaxPool2D(3, 2, ceil_mode=True),
                       [_u(2, 2, 8, 8)]),
    "maxpool3d": (lambda p: p.gluon.nn.MaxPool3D(), [_u(1, 2, 4, 4, 4)]),
    "avgpool1d": (lambda p: p.gluon.nn.AvgPool1D(2), [_u(2, 2, 8)]),
    "avgpool2d_nopad_count": (
        lambda p: p.gluon.nn.AvgPool2D(3, 2, 1, count_include_pad=False),
        [_u(2, 2, 7, 7)]),
    "avgpool3d": (lambda p: p.gluon.nn.AvgPool3D(2), [_u(1, 2, 4, 4, 4)]),
    "global_pools": (lambda p: _seq(p, p.gluon.nn.GlobalMaxPool2D(),
                                    p.gluon.nn.GlobalAvgPool2D()),
                     [_u(2, 3, 4, 4)]),
    "global_pools_1d_3d": (
        lambda p: _seq(p, p.gluon.nn.GlobalAvgPool1D(),
                       p.gluon.nn.GlobalMaxPool1D()), [_u(2, 3, 5)]),
    "global_pool_3d": (lambda p: p.gluon.nn.GlobalAvgPool3D(),
                       [_u(1, 2, 3, 3, 3)]),
    "activations": (lambda p: _seq(p, *[p.gluon.nn.Activation(a) for a in (
        "relu", "sigmoid", "tanh", "softrelu", "softsign")]), [_u(3, 4)]),
    "swish": (lambda p: p.gluon.nn.Swish(1.5), [_u(3, 4)]),
    "reflection_pad": (lambda p: p.gluon.nn.ReflectionPad2D(1),
                       [_u(1, 2, 3, 3)]),
    "hybrid_lambda": (lambda p: p.gluon.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2), [_u(3, 4)]),
    "hybrid_lambda_name": (lambda p: p.gluon.nn.HybridLambda("tanh"),
                           [_u(3, 4)]),
    "lambda": (lambda p: p.gluon.nn.Lambda("sigmoid"), [_u(3, 4)]),
    "sequential": (lambda p: _seq(p, p.gluon.nn.Dense(6, activation="relu"),
                                  p.gluon.nn.Dense(2), hybrid=False),
                   [_u(3, 4)]),
}


def _seq(pkg, *blocks, hybrid=True):
    net = (pkg.gluon.nn.HybridSequential if hybrid
           else pkg.gluon.nn.Sequential)()
    with net.name_scope():
        net.add(*blocks)
    return net


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name):
    make, inputs = LAYERS[name]
    _hold(make, inputs)


@pytest.mark.parametrize("make", [
    lambda p: p.gluon.model_zoo.vision.get_model("alexnet"),
], ids=["alexnet"])
def test_layers_waiting_for_their_ops_raise(make):
    """A model-zoo family raised NotImplementedError until its layers were
    ported (alexnet, until slice 16): now it builds, with the JAX
    package's parameter names, and runs on the CPU."""
    with mx.cpu():
        net = make(mx)
        net.initialize()
        assert net(mx.nd.zeros((1, 3, 64, 64))).shape == (1, 1000)
    want = make(jmx)
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(want._collect_params_with_prefix())


def _hybrid_net(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="n_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu"),
                pkg.gluon.nn.BatchNorm(), pkg.gluon.nn.Dense(4))
    return net


def test_hybridized_matches_eager_and_jax():
    x = [_u(5, 8)]
    eager = _hold(_hybrid_net, x)
    hybrid = _hold(_hybrid_net, x, hybridize=True)
    for a, b in zip(eager[0], hybrid[0]):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_hybrid_deferred_init():
    with CPU:
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Conv2D(4, 3, padding=1),
                    mx.gluon.nn.BatchNorm(), mx.gluon.nn.Dense(3))
        net.initialize()
        net.hybridize()
        out = net(mx.nd.zeros((2, 3, 8, 8)))
    assert out.shape == (2, 3)
    assert net[0].weight.shape == (4, 3, 3, 3)
    assert net[2].weight.shape == (3, 4 * 8 * 8)
    # the shape pass ran on meta tensors: the moving stats did not move
    np.testing.assert_array_equal(_np(net[1].running_mean.data()), 0.0)


def test_hybridized_batchnorm_moves_stats_like_eager():
    """The port's choice (ROADMAP, "Known reference-side behaviour"): one
    `record()` step of a hybridized Conv2D + BatchNorm moves the moving
    stats exactly as the eager block does. The JAX package's hybridized
    path leaves them at their initial values."""
    x = _u(4, 3, 6, 6, seed=2)

    def stats(pkg, hybridize):
        ctx = CPU if pkg is mx else jmx.cpu()
        with ctx:
            net = pkg.gluon.nn.HybridSequential(prefix="m_")
            with net.name_scope():
                net.add(pkg.gluon.nn.Conv2D(4, 3, in_channels=3),
                        pkg.gluon.nn.BatchNorm(in_channels=4))
            net.initialize(pkg.init.One(), ctx=ctx)
            if hybridize:
                net.hybridize()
            with pkg.autograd.record():
                y = net(pkg.nd.array(x))
            y.backward()
            return _np(net[1].running_mean.data())

    eager = stats(jmx, False)
    assert np.abs(eager).max() > 0
    np.testing.assert_allclose(stats(mx, True), eager, **TOL)
    np.testing.assert_allclose(stats(mx, False), eager, **TOL)
    np.testing.assert_array_equal(stats(jmx, True), 0.0)


def test_block_surface(tmp_path, capsys):
    net = _hybrid_net(mx)
    assert sorted(net.collect_params().keys()) == sorted(
        _hybrid_net(jmx).collect_params().keys())
    assert list(net.collect_params("n_dense0.*").keys()) == [
        "n_dense0_weight", "n_dense0_bias"]
    seen = []
    h = net[0].register_forward_hook(lambda b, i, o: seen.append(o.shape))
    net.initialize(ctx=CPU)
    net.summary(mx.nd.ones((2, 8), ctx=CPU))
    assert "Total params" in capsys.readouterr().out
    assert seen == [(2, 16)]
    h.detach()
    visited = []
    net.apply(lambda b: visited.append(type(b).__name__))
    assert visited[-1] == "HybridSequential" and len(visited) == 5
    net.hybridize()
    net(mx.nd.ones((2, 8), ctx=CPU))
    assert net._cached_op is not None
    net.cast("bfloat16")
    assert net._cached_op is None  # cast clears the cached op
    assert net[1].gamma.data()._data.dtype.is_floating_point
    sym = net.export(str(tmp_path / "m"))
    assert (tmp_path / "m-symbol.json").exists()
    assert (tmp_path / "m-0000.params").exists()
    assert sym.list_arguments()[0] == "data"


def test_save_load_parameters_cross_packages_bit_for_bit(tmp_path):
    x = _u(2, 8)
    ref = _hybrid_net(jmx)
    ref.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    ref(jmx.nd.array(x))
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    jmx.nd.load(f)  # waits for the JAX package's writer
    port = _hybrid_net(mx)
    port.load_parameters(f, ctx=CPU)
    want = {k: _np(p.data()) for k, p in
            ref._collect_params_with_prefix().items()}
    got = {k: _np(p.data()) for k, p in
           port._collect_params_with_prefix().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # and back: the port's file into a fresh JAX block
    port2 = _hybrid_net(mx)
    port2.initialize(mx.init.Xavier(), ctx=CPU)
    port2(mx.nd.array(x, ctx=CPU))
    f2 = str(tmp_path / "port.params")
    port2.save_parameters(f2)
    back = _hybrid_net(jmx)
    back.load_parameters(f2, ctx=jmx.cpu())
    for k, p in port2._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            _np(back._collect_params_with_prefix()[k].data()), _np(p.data()))
    again = str(tmp_path / "again.params")
    back.save_parameters(again)
    jmx.nd.load(again)
    assert open(f2, "rb").read() == open(again, "rb").read()


# -- losses -------------------------------------------------------------------

def _labels(n, classes, seed=1):
    return np.random.RandomState(seed).randint(0, classes, n).astype(
        np.float32)


LOSSES = {
    "l2": (lambda p: p.gluon.loss.L2Loss(), [_u(4, 3), _u(4, 3, seed=1)]),
    "l1_weighted": (lambda p: p.gluon.loss.L1Loss(weight=0.5),
                    [_u(4, 3), _u(4, 3, seed=1), _u(4, 1, seed=2)]),
    "sigmoid_bce": (lambda p: p.gluon.loss.SigmoidBCELoss(),
                    [_u(4, 3), _u(4, 3, seed=1, lo=0)]),
    "sigmoid_bce_from_sigmoid": (
        lambda p: p.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
        [_u(4, 3, lo=0.1, hi=0.9), _u(4, 3, seed=1, lo=0)]),
    "softmax_ce": (lambda p: p.gluon.loss.SoftmaxCrossEntropyLoss(),
                   [_u(4, 5), _labels(4, 5)]),
    "softmax_ce_dense": (
        lambda p: p.gluon.loss.SoftmaxCELoss(sparse_label=False),
        [_u(4, 5), _u(4, 5, seed=1, lo=0)]),
    "kldiv": (lambda p: p.gluon.loss.KLDivLoss(from_logits=False),
              [_u(4, 5), _u(4, 5, seed=1, lo=0.1)]),
    "huber": (lambda p: p.gluon.loss.HuberLoss(rho=0.5),
              [_u(4, 3), _u(4, 3, seed=1)]),
    "hinge": (lambda p: p.gluon.loss.HingeLoss(), [_u(4, 3), _u(4, 3, seed=1)]),
    "squared_hinge": (lambda p: p.gluon.loss.SquaredHingeLoss(),
                      [_u(4, 3), _u(4, 3, seed=1)]),
    "logistic_binary": (lambda p: p.gluon.loss.LogisticLoss(
        label_format="binary"), [_u(4, 3), _u(4, 3, seed=1, lo=0)]),
    "triplet": (lambda p: p.gluon.loss.TripletLoss(),
                [_u(4, 3), _u(4, 3, seed=1), _u(4, 3, seed=2)]),
    "poisson_nll_full": (lambda p: p.gluon.loss.PoissonNLLLoss(
        from_logits=False, compute_full=True),
        [_u(4, 3, lo=0.5, hi=2), _u(4, 3, seed=1, lo=0.5, hi=3)]),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(name):
    """Each loss against the JAX package's eager one; PoissonNLLLoss with
    ``compute_full`` against its hybridized one: the JAX package's eager
    ``loss += stirling`` leaves the Stirling term out of the gradient
    (ROADMAP, "Known reference-side behaviour")."""
    make, inputs = LOSSES[name]
    _hold(make, inputs, hybridize=name == "softmax_ce",
          ref_hybridize=name == "poisson_nll_full")


def test_cosine_embedding_loss_closed_form():
    """The JAX package's CosineEmbeddingLoss raises (its
    ``broadcast_maximum(..., axis=1)`` is refused by its own op): the port
    is held to the reference's formula in numpy."""
    x1, x2 = _u(4, 3), _u(4, 3, seed=1)
    label = np.array([1, -1, 1, -1], np.float32)
    with jmx.cpu(), pytest.raises(jmx.base.MXNetError, match="axis"):
        jmx.gluon.loss.CosineEmbeddingLoss()(
            jmx.nd.array(x1), jmx.nd.array(x2), jmx.nd.array(label))
    a, b = mx.nd.array(x1, ctx=CPU), mx.nd.array(x2, ctx=CPU)
    a.attach_grad()
    with mx.autograd.record():
        loss = mx.gluon.loss.CosineEmbeddingLoss(margin=0.1)(
            a, b, mx.nd.array(label, ctx=CPU))
    loss.backward()
    cos = (x1 * x2).sum(1) / np.maximum(
        np.linalg.norm(x1, axis=1) * np.linalg.norm(x2, axis=1), 1e-12)
    want = np.where(label == 1, 1 - cos, np.maximum(0, cos - 0.1))
    np.testing.assert_allclose(_np(loss), want, **TOL)
    assert np.isfinite(_np(a.grad)).all() and np.abs(_np(a.grad)).max() > 0


# -- gluon.utils -------------------------------------------------------------

def test_split_and_clip_match_jax():
    a = _u(6, 4)
    for pkg, ctx in ((mx, CPU), (jmx, jmx.cpu())):
        with ctx:
            parts = pkg.gluon.utils.split_data(pkg.nd.array(a), 3)
            assert [p.shape for p in parts] == [(2, 4)] * 3
            uneven = pkg.gluon.utils.split_data(pkg.nd.array(a), 4,
                                                even_split=False)
            assert [p.shape[0] for p in uneven] == [1, 1, 1, 3]
            with pytest.raises(ValueError):
                pkg.gluon.utils.split_data(pkg.nd.array(a), 4)
            loaded = pkg.gluon.utils.split_and_load(a, [ctx])
            np.testing.assert_array_equal(_np(loaded[0]), a)
    arrays = {pkg: [pkg.nd.array(_u(3, 4, seed=s), ctx=c) for s in (0, 1)]
              for pkg, c in ((mx, CPU), (jmx, jmx.cpu()))}
    norm = mx.gluon.utils.clip_global_norm(arrays[mx], 1.0)
    jnorm = jmx.gluon.utils.clip_global_norm(arrays[jmx], 1.0)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-6)
    for a, b in zip(arrays[mx], arrays[jmx]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


# -- io -------------------------------------------------------------------------

@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    data = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    label = np.arange(10, dtype=np.float32)

    def epochs(pkg):
        np.random.seed(11)
        with (CPU if pkg is mx else jmx.cpu()):
            it = pkg.io.NDArrayIter({"x": data}, {"y": label}, batch_size=4,
                                    shuffle=shuffle, last_batch_handle=handle)
            out = [(d.name, d.shape) for d in it.provide_data]
            for _ in range(2):
                it.reset()
                out += [([_np(a) for a in b.data], [_np(a) for a in b.label],
                         b.pad) for b in it]
        return out

    got, want = epochs(mx), epochs(jmx)
    assert len(got) == len(want)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        for ga, wa in zip(g[0] + g[1], w[0] + w[1]):
            np.testing.assert_array_equal(ga, wa)
        assert g[2] == w[2]


def test_resize_iter_databatch_and_datadesc():
    it = mx.io.NDArrayIter(np.ones((5, 2), np.float32), batch_size=2)
    with CPU:
        resized = mx.io.ResizeIter(it, 7)
        assert len(list(resized)) == 7
        resized.reset()
        assert resized.next().data[0].shape == (2, 2)
    desc = mx.io.DataDesc("data", (2, 3))
    assert desc.dtype == np.float32 and desc.layout == "NCHW"
    assert mx.io.DataDesc.get_batch_axis("TNC") == 1
    with pytest.raises(TypeError):
        mx.io.DataBatch(mx.nd.ones((1,), ctx=CPU))
    with CPU:
        it.reset()
        prefetched = mx.io.PrefetchingIter([it])
        assert [b.data[0].shape for b in prefetched] == [(2, 2)] * 3


# -- metric --------------------------------------------------------------------

METRICS = {
    "acc": lambda p: p.metric.Accuracy(),
    "top_k": lambda p: p.metric.TopKAccuracy(top_k=3),
    "ce": lambda p: p.metric.create("ce"),
    "perplexity": lambda p: p.metric.Perplexity(ignore_label=0),
    "loss": lambda p: p.metric.Loss(),
    "mae": lambda p: p.metric.MAE(),
    "mse": lambda p: p.metric.MSE(),
    "rmse": lambda p: p.metric.create("rmse"),
    "f1": lambda p: p.metric.F1(),
    "mcc": lambda p: p.metric.MCC(),
    "composite": lambda p: p.metric.create(["acc", "ce"]),
    "custom": lambda p: p.metric.np(lambda l, q: float(np.abs(l - q.argmax(
        1)).sum())),
}


@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_jax(name):
    rng = np.random.RandomState(4)
    pred = rng.dirichlet(np.ones(5), 12).astype(np.float32)
    binary = rng.dirichlet(np.ones(2), 12).astype(np.float32)
    label = rng.randint(0, 5, 12).astype(np.float32)
    blabel = rng.randint(0, 2, 12).astype(np.float32)

    def value(pkg):
        ctx = CPU if pkg is mx else jmx.cpu()
        m = METRICS[name](pkg)
        p, l = (binary, blabel) if name in ("f1", "mcc") else (pred, label)
        if name in ("mae", "mse", "rmse"):
            p = pred[:, 0]
        for half in (slice(0, 6), slice(6, 12)):
            m.update([pkg.nd.array(l[half], ctx=ctx)],
                     [pkg.nd.array(p[half], ctx=ctx)])
        return m.get()

    got, want = value(mx), value(jmx)
    assert got[0] == want[0]
    np.testing.assert_allclose(np.asarray(got[1], np.float64),
                               np.asarray(want[1], np.float64), rtol=1e-6)


# -- lr_scheduler ---------------------------------------------------------------

SCHEDULERS = {
    "factor": lambda p: p.lr_scheduler.FactorScheduler(
        step=3, factor=0.5, base_lr=1.0, warmup_steps=2, warmup_begin_lr=0.1),
    "multifactor": lambda p: p.lr_scheduler.MultiFactorScheduler(
        step=[2, 5, 9], factor=0.3, base_lr=0.5),
    "poly": lambda p: p.lr_scheduler.PolyScheduler(
        max_update=12, base_lr=0.2, pwr=2, final_lr=0.01, warmup_steps=3),
    "cosine": lambda p: p.lr_scheduler.CosineScheduler(
        max_update=12, base_lr=0.2, final_lr=0.02, warmup_steps=2,
        warmup_mode="constant", warmup_begin_lr=0.05),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_lr_scheduler_matches_jax(name):
    got, want = SCHEDULERS[name](mx), SCHEDULERS[name](jmx)
    assert [got(t) for t in range(16)] == [want(t) for t in range(16)]


def test_lr_scheduler_drives_the_trainer():
    def run(pkg, ctx):
        sched = pkg.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        p = pkg.gluon.Parameter("w_weight", shape=(2,))
        p.initialize(pkg.init.One(), ctx=ctx)
        trainer = pkg.gluon.Trainer([p], "sgd", {"learning_rate": 1.0,
                                                 "lr_scheduler": sched})
        for _ in range(3):
            with pkg.autograd.record():
                y = (p.data() * 1.0).sum()
            y.backward()
            trainer.step(1)
        with pytest.raises(UserWarning):
            trainer.set_learning_rate(0.1)
        return _np(p.data()), trainer.learning_rate

    (w, lr), (jw, jlr) = run(mx, CPU), run(jmx, jmx.cpu())
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(w, 1.0 - 1.0 - 0.5 - 0.25)
    assert lr == jlr == 1.0  # the base rate, in both packages


# -- Trainer --------------------------------------------------------------------

def _train_steps(trainer, net, n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        x = mx.nd.array(rng.uniform(-1, 1, (4, 8)), ctx=CPU)
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        trainer.step(4)


def test_trainer_save_load_states_round_trip(tmp_path):
    def make():
        net = _hybrid_net(mx)
        net.initialize(mx.init.Xavier(), ctx=CPU)
        net(mx.nd.ones((4, 8), ctx=CPU))
        return net

    net = make()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    _train_steps(trainer, net, 2, seed=0)
    f = str(tmp_path / "trainer.states")
    trainer.save_states(f)
    f_params = str(tmp_path / "net.params")
    net.save_parameters(f_params)
    twin = make()
    twin.load_parameters(f_params, ctx=CPU)
    twin_trainer = mx.gluon.Trainer(twin.collect_params(), "sgd",
                                    {"learning_rate": 0.5})
    twin_trainer.load_states(f)
    assert twin_trainer._optimizer.lr == 0.1
    assert twin_trainer._optimizer.momentum == 0.9
    _train_steps(trainer, net, 2, seed=1)
    _train_steps(twin_trainer, twin, 2, seed=1)
    for k, p in net._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            _np(twin._collect_params_with_prefix()[k].data()), _np(p.data()))


def test_trainer_refuses_stale_gradients_and_dedups():
    def run(pkg, ctx):
        a = pkg.gluon.Parameter("a_weight", shape=(2,))
        b = pkg.gluon.Parameter("b_weight", shape=(2,))
        for p in (a, b):
            p.initialize(pkg.init.One(), ctx=ctx)
        trainer = pkg.gluon.Trainer([a, b, a], "sgd", {"learning_rate": 0.1})
        assert len(trainer._params) == 2
        with pkg.autograd.record():
            y = (a.data() * 2).sum()
        y.backward()
        with pytest.raises(UserWarning, match="b_weight"):
            trainer.step(1)  # refused before any update
        # a's gradient was spent by the refused step: nothing to update
        trainer.step(1, ignore_stale_grad=True)
        with pkg.autograd.record():
            y = (a.data() * 2).sum()
        y.backward()
        trainer.step(1, ignore_stale_grad=True)
        with pytest.raises(ValueError):
            pkg.gluon.Trainer([a, "b"], "sgd")
        return _np(a.data()), _np(b.data())

    got, want = run(mx, CPU), run(jmx, jmx.cpu())
    np.testing.assert_allclose(got[0], 1.0 - 0.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_model_zoo_names_and_pretrained(tmp_path):
    """``pretrained=True`` loads from the model store and raises
    `FileNotFoundError` without the file (C.8, slice 16; before it the
    port refused), every family builds (`test_torch_model_store.py` holds
    the names and the loading to the JAX package's), an unknown name
    raises."""
    vision = mx.gluon.model_zoo.vision
    with pytest.raises(FileNotFoundError, match="resnet18_v1.params"):
        vision.resnet18_v1(pretrained=True, root=str(tmp_path))
    assert type(vision.get_model("vgg16")).__name__ == "VGG"
    with pytest.raises(ValueError):
        vision.get_model("resnet19_v1")
    for name in ("resnet18_v1", "resnet34_v2", "resnet50_v1", "resnet50_v2",
                 "resnet101_v1", "resnet152_v2"):
        got = vision.get_model(name, classes=7)
        want = jmx.gluon.model_zoo.vision.get_model(name, classes=7)
        gp = {k: v.shape for k, v in got._collect_params_with_prefix().items()}
        wp = {k: v.shape for k, v in
              want._collect_params_with_prefix().items()}
        assert gp == wp, name

