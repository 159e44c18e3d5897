"""Row-sparse gradients end to end, the port against the JAX package on the
CPU: the cases of `tests/python/unittest/test_sparse_grad.py` (the
gradient's stype, sparse against dense, ``grad_req="add"``, lazy SGD with
momentum and lazy Adam, `row_sparse_data`, a 1,000,000 x 32 table trained
without densifying, the hybridized dense fallback, `cast` and `zero_grad`
keeping the buffer sparse, two CPU contexts through ``kvstore="device"``,
`list_row_sparse_data`), both models of `chip_smoke.py`'s sparse phase
at `SPARSE_SMALL` for two steps, and the repo's two sparse examples
through the port. ``dist_sync``'s padded row-sparse push over two gloo
workers is `test_torch_kvstore.py`'s.

Tolerances: values within rtol 1e-6 / atol 1e-7 (fp32 arithmetic in
another order; the atol covers entries near zero), index sets and
untouched rows exactly.
"""
import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

CPU = mx.cpu()
TOL = {"rtol": 1e-6, "atol": 1e-7}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with CPU:
        yield


def _embedding_grad(pkg, w, ids, sparse, head=None, req="write"):
    """The weight gradient of Embedding over ``ids`` on ``pkg``: of
    sum(y * y), or of y against the cotangent ``head``."""
    x = pkg.nd.array(w)
    x.attach_grad(grad_req=req, stype="row_sparse" if sparse else None)
    for rows in ids:
        with pkg.autograd.record():
            y = pkg.nd.Embedding(pkg.nd.array(rows, dtype="int32"), x,
                                 input_dim=w.shape[0],
                                 output_dim=w.shape[1], sparse_grad=sparse)
            loss = (y * y).sum() if head is None else y
        loss.backward(None if head is None else pkg.nd.array(head))
    return x.grad


def test_embedding_sparse_grad_stype():
    w = np.random.RandomState(0).normal(0, 1, (50, 8)).astype(np.float32)
    ids = [[[1, 3], [3, 7]]]
    g = _embedding_grad(mx, w, ids, True)
    want = _embedding_grad(jmx, w, ids, True)
    assert isinstance(g, RowSparseNDArray) and g.stype == "row_sparse"
    assert not g.densified()
    np.testing.assert_array_equal(g.indices.asnumpy(), [1, 3, 7])
    np.testing.assert_array_equal(g.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_allclose(g.data.asnumpy(), want.data.asnumpy(), **TOL)
    np.testing.assert_allclose(g.data.asnumpy()[1], 4 * w[3], rtol=1e-6)


def test_embedding_sparse_vs_dense_grad():
    rng = np.random.RandomState(0)
    w = rng.rand(30, 5).astype(np.float32)
    ids = [rng.randint(0, 30, size=(4, 6))]
    head = rng.rand(4, 6, 5).astype(np.float32)
    sparse = _embedding_grad(mx, w, ids, True, head)
    dense = _embedding_grad(mx, w, ids, False, head)
    want = _embedding_grad(jmx, w, ids, True, head)
    assert type(dense) is nd.NDArray
    np.testing.assert_allclose(sparse.asnumpy(), dense.asnumpy(), **TOL)
    np.testing.assert_allclose(sparse.asnumpy(), want.asnumpy(), **TOL)


def test_indices_out_of_range_are_clipped_as_the_forward_does():
    w = np.ones((6, 2), np.float32)
    g = _embedding_grad(mx, w, [[-3, 2, 9]], True)
    want = _embedding_grad(jmx, w, [[-3, 2, 9]], True)
    np.testing.assert_array_equal(g.indices.asnumpy(), [0, 2, 5])
    np.testing.assert_array_equal(g.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_allclose(g.data.asnumpy(), want.data.asnumpy())


def test_sparse_grad_req_add():
    w = np.ones((10, 3), np.float32)
    g = _embedding_grad(mx, w, [[1, 2], [2, 5]], True, req="add")
    assert isinstance(g, RowSparseNDArray) and not g.densified()
    np.testing.assert_array_equal(g.indices.asnumpy(), [1, 2, 5])
    np.testing.assert_allclose(g.data.asnumpy(),
                               [[2] * 3, [4] * 3, [2] * 3])
    want = _embedding_grad(jmx, w, [[1, 2], [2, 5]], True, req="add")
    np.testing.assert_allclose(g.data.asnumpy(), want.data.asnumpy())


def test_a_sparse_gradient_meeting_a_dense_one_densifies():
    """The weight read by a sparse Embedding and by a dense op: its
    gradient reaches the row-sparse buffer dense, as in the JAX package,
    and the buffer's components come back from it."""
    w = np.random.RandomState(1).rand(8, 3).astype(np.float32)
    got = {}
    for pkg in (mx, jmx):
        x = pkg.nd.array(w)
        x.attach_grad(stype="row_sparse")
        with pkg.autograd.record():
            y = pkg.nd.Embedding(pkg.nd.array([2, 2], dtype="int32"), x,
                                 input_dim=8, output_dim=3, sparse_grad=True)
            loss = y.sum() + (x * x).sum()
        loss.backward()
        got[pkg] = x.grad
    np.testing.assert_allclose(got[mx].asnumpy(), got[jmx].asnumpy(), **TOL)
    np.testing.assert_array_equal(got[mx].indices.asnumpy(), np.arange(8))


def test_inside_a_cond_branch_the_gradient_is_dense():
    """A control-flow body's gradient gates take dense gradients: the
    Embedding there gives one, as inside the JAX package's traced branch,
    and the row-sparse buffer takes it."""
    w = np.random.RandomState(4).rand(6, 2).astype(np.float32)
    got = {}
    for pkg in (mx, jmx):
        x = pkg.nd.array(w)
        x.attach_grad(stype="row_sparse")
        ids = pkg.nd.array([1, 3, 3], dtype="int32")
        with pkg.autograd.record():
            out = pkg.nd.contrib.cond(
                pkg.nd.array([1.0]),
                lambda: pkg.nd.Embedding(ids, x, input_dim=6, output_dim=2,
                                         sparse_grad=True).sum(),
                lambda: (x * 0).sum())
        out.backward()
        got[pkg] = x.grad
    np.testing.assert_allclose(got[mx].asnumpy(), got[jmx].asnumpy(), **TOL)
    np.testing.assert_array_equal(got[mx].indices.asnumpy(), [1, 3])


def test_autograd_grad_is_dense():
    w = np.random.RandomState(2).rand(6, 2).astype(np.float32)
    x = nd.array(w)
    x.attach_grad()
    with autograd.record():
        y = nd.Embedding(nd.array([1, 4, 1], dtype="int32"), x,
                         input_dim=6, output_dim=2, sparse_grad=True).sum()
    g = autograd.grad(y, x)
    want = np.zeros_like(w)
    want[1], want[4] = 2, 1
    assert type(g) is nd.NDArray
    np.testing.assert_array_equal(g.asnumpy(), want)


def _sparse_net(pkg, kind, n, d, w0):
    net = pkg.gluon.contrib.nn.SparseEmbedding(n, d) if kind == "contrib" \
        else pkg.gluon.nn.Embedding(n, d, sparse_grad=True)
    net.initialize(ctx=pkg.cpu())
    net.weight.set_data(pkg.nd.array(w0))
    return net


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 0.5})],
    ids=["sgd_momentum", "sgd_wd", "adam", "adam_wd_clip"])
def test_lazy_updates_touch_only_the_rows(opt, params):
    """Lazy SGD and Adam: the touched rows move as the JAX package's, every
    other row of the weight and of the states stays bit-equal, and the
    gradient is never densified."""
    n, d = 1000, 16
    w0 = np.random.RandomState(1).rand(n, d).astype(np.float32)
    batches = [[3, 3, 7], [7, 11]]
    out = {}
    for pkg in (mx, jmx):
        net = _sparse_net(pkg, "contrib", n, d, w0)
        trainer = pkg.gluon.Trainer(net.collect_params(), opt, params)
        for rows in batches:
            with pkg.autograd.record():
                loss = (net(pkg.nd.array(rows, dtype="int32")) ** 2).sum()
            loss.backward()
            g = net.weight.grad()
            assert isinstance(g, (RowSparseNDArray,
                                  jmx.ndarray.sparse.RowSparseNDArray))
            trainer.step(1)
            assert not g.densified()
        names = [net.weight.name]
        out[pkg] = (net.weight.data().asnumpy(),
                    cs.sparse_opt_states(trainer, names))
    (w, states), (jw, jstates) = out[mx], out[jmx]
    untouched = np.setdiff1d(np.arange(n), [3, 7, 11])
    np.testing.assert_array_equal(w[untouched], w0[untouched])
    np.testing.assert_allclose(w, jw, **TOL)
    assert sorted(states) == sorted(jstates)
    for k in jstates:
        np.testing.assert_allclose(states[k], jstates[k], err_msg=k, **TOL)
        assert not states[k][untouched].any(), k


def test_lazy_update_off_is_the_dense_update():
    n, d = 50, 4
    w0 = np.random.RandomState(3).rand(n, d).astype(np.float32)
    out = {}
    for pkg in (mx, jmx):
        net = _sparse_net(pkg, "nn", n, d, w0)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "wd": 0.1,
                                     "lazy_update": False})
        with pkg.autograd.record():
            loss = net(pkg.nd.array([5], dtype="int32")).sum()
        loss.backward()
        trainer.step(1)
        out[pkg] = net.weight.data().asnumpy()
    np.testing.assert_allclose(out[mx], out[jmx], **TOL)
    # weight decay moved every row
    np.testing.assert_allclose(out[mx][0], w0[0] * (1 - 0.1 * 0.1),
                               rtol=1e-6)


def test_parameter_row_sparse_data():
    net = gluon.nn.Embedding(20, 6, sparse_grad=True)
    net.initialize(ctx=CPU)
    rsp = net.weight.row_sparse_data(nd.array([2, 9, 2], dtype="int64"))
    assert isinstance(rsp, RowSparseNDArray)
    np.testing.assert_array_equal(rsp.indices.asnumpy(), [2, 9])
    np.testing.assert_allclose(rsp.data.asnumpy(),
                               net.weight.data().asnumpy()[[2, 9]])
    dense = gluon.nn.Dense(3, in_units=4)
    dense.initialize(ctx=CPU)
    with pytest.raises(MXNetError):
        dense.weight.row_sparse_data(nd.array([0], dtype="int64"))


def test_list_row_sparse_data_per_context():
    net = gluon.nn.Embedding(30, 4, sparse_grad=True)
    net.initialize(ctx=[mx.cpu(0), mx.cpu(1)])
    outs = net.weight.list_row_sparse_data(nd.array([4, 1], dtype="int32"))
    assert len(outs) == 2
    for o, w in zip(outs, net.weight.list_data()):
        assert isinstance(o, RowSparseNDArray)
        np.testing.assert_array_equal(o.indices.asnumpy(), [1, 4])
        np.testing.assert_array_equal(o.data.asnumpy(),
                                      w.asnumpy()[[1, 4]])


def test_big_embedding_trains_without_densify():
    """A 1,000,000 x 32 table, three steps: the gradient holds at most the
    batch's 64 rows, is never densified, and the touched rows take the
    plain SGD step (loss sum(y^2): each row's gradient is 2 w times its
    count, rescaled by 1/64)."""
    n, d = 1_000_000, 32
    net = gluon.contrib.nn.SparseEmbedding(n, d)
    net.initialize(ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.5})
    rng = np.random.RandomState(0)
    for _ in range(3):
        ids = rng.randint(0, n, size=(64,))
        rows, counts = np.unique(ids, return_counts=True)
        before = net.weight.data().asnumpy()[rows]
        with autograd.record():
            loss = (net(nd.array(ids, dtype="int32")) ** 2).sum()
        loss.backward()
        g = net.weight.grad()
        assert isinstance(g, RowSparseNDArray)
        np.testing.assert_array_equal(g.indices.asnumpy(), rows)
        trainer.step(64)
        assert not g.densified(), "the 1M-row gradient was densified"
        after = net.weight.data().asnumpy()[rows]
        want = before - 0.5 * 2 * counts[:, None] * before / 64
        np.testing.assert_allclose(after, want, rtol=1e-6)
    net.collect_params().zero_grad()
    assert not g.densified() and g.indices.shape == (0,)


def test_hybridized_embedding_falls_back_dense_correct():
    """A hybridized block's function gives a dense gradient (the JAX
    package's rule, and a captured graph could not hold the row count);
    it lands in the row-sparse buffer with the right values."""
    out = {}
    for pkg in (mx, jmx):
        net = pkg.gluon.nn.Embedding(15, 4, sparse_grad=True)
        net.initialize(ctx=pkg.cpu())
        net.hybridize()
        with pkg.autograd.record():
            loss = net(pkg.nd.array([1, 1, 4], dtype="int32")).sum()
        loss.backward()
        out[pkg] = net.weight.grad()
    expected = np.zeros((15, 4), np.float32)
    expected[1], expected[4] = 2, 1
    assert isinstance(out[mx], RowSparseNDArray)
    np.testing.assert_allclose(out[mx].asnumpy(), expected)
    np.testing.assert_allclose(out[jmx].asnumpy(), expected)
    np.testing.assert_array_equal(out[mx].indices.asnumpy(), [1, 4])


def test_cast_preserves_sparse_grad_buffer():
    net = gluon.nn.Embedding(40, 4, sparse_grad=True)
    net.initialize(ctx=CPU)
    net.cast("float16")
    g = net.weight.grad()
    assert isinstance(g, RowSparseNDArray) and g.dtype == np.float16
    with autograd.record():
        loss = net(nd.array([3], dtype="int32")).sum()
    loss.backward()
    g = net.weight.grad()
    assert isinstance(g, RowSparseNDArray) and g.dtype == np.float16
    np.testing.assert_array_equal(g.indices.asnumpy(), [3])


def test_zero_grad_stays_sparse():
    net = gluon.contrib.nn.SparseEmbedding(5000, 8)
    net.initialize(ctx=CPU)
    net.weight.grad_req = "add"
    with autograd.record():
        loss = net(nd.array([7, 9], dtype="int32")).sum()
    loss.backward()
    assert net.weight.grad().indices.shape[0] == 2
    net.collect_params().zero_grad()
    g = net.weight.grad()
    assert isinstance(g, RowSparseNDArray)
    assert not g.densified(), "zero_grad materialized the dense table"
    assert g.indices.shape[0] == 0


def test_multi_device_trainer_sparse_no_densify():
    """Two CPU contexts through ``kvstore="device"``: the replicas'
    gradients merge sparsely, each replica takes the summed step. The
    port's CPU contexts share one torch device, so a block's forward would
    read replica 0 for both: each batch reads its replica explicitly."""
    n, d = 10000, 8
    ctxs = [mx.cpu(0), mx.cpu(1)]
    net = gluon.contrib.nn.SparseEmbedding(n, d)
    net.initialize(ctx=ctxs)
    w0 = net.weight.data(ctxs[0]).asnumpy().copy()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore="device")
    batches = [[5], [5, 11]]
    with autograd.record():
        losses = [nd.Embedding(nd.array(b, dtype="int32"),
                               net.weight.data(c), input_dim=n,
                               output_dim=d, sparse_grad=True).sum()
                  for b, c in zip(batches, ctxs)]
    autograd.backward(losses)
    trainer.step(1)
    for g in net.weight.list_grad():
        assert isinstance(g, RowSparseNDArray)
        assert not g.densified(), "a replica's sparse gradient was densified"
        np.testing.assert_array_equal(g.indices.asnumpy(), [5, 11])
    untouched = np.setdiff1d(np.arange(n), [5, 11])
    for c in ctxs:
        w1 = net.weight.data(c).asnumpy()
        np.testing.assert_array_equal(w1[untouched], w0[untouched])
        np.testing.assert_allclose(w1[5], w0[5] - 0.1 * 2.0, rtol=1e-6)
        np.testing.assert_allclose(w1[11], w0[11] - 0.1 * 1.0, rtol=1e-6)


def test_trainer_keeps_the_optimizer_off_the_store():
    net = gluon.contrib.nn.SparseEmbedding(20, 2)
    net.initialize(ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore="local")
    trainer._init_kvstore()
    assert trainer._update_on_kvstore is False


@pytest.fixture(scope="module")
def jax_small_runs():
    return {(kind, opt): cs.sparse_small_run(jmx, jmx.cpu(), kind, opt)
            for kind in ("linear", "mf") for opt in ("sgd", "adam")}


@pytest.mark.parametrize("kind", ["linear", "mf"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_sparse_phase_models_match_jax(jax_small_runs, kind, opt):
    """The sparse phase's two models (`linear_classification.py`'s
    SparseLinear, `matrix_fact.py`'s MFNet) at `SPARSE_SMALL`, two steps
    from the same numpy weights: the losses, every weight, the SGD momentum
    or both Adam moments, and each step's gradient indices."""
    losses, state = cs.sparse_small_run(mx, CPU, kind, opt)
    want_losses, want_state = jax_small_runs[(kind, opt)]
    np.testing.assert_allclose(np.stack(losses), np.stack(want_losses),
                               rtol=1e-6, atol=1e-6)
    n, _ = cs.sparse_compare(f"{kind} {opt}", state, want_state, TOL)
    assert n == len(want_state) >= 4


def test_linear_classification_example_runs_on_the_port():
    figures = cs.run_linear_example([], ctx=CPU)
    assert figures["final train accuracy"] > cs.LINEAR_EXAMPLE_ACC


def test_matrix_fact_example_runs_on_the_port():
    figures = cs.run_mf_example(["--epochs", str(cs.MF_EXAMPLE_EPOCHS)],
                                ctx=CPU)
    assert figures["embedding_grad_stype"] == "row_sparse"
    assert figures["final_rmse"] < cs.MF_EXAMPLE_RMSE


def test_sparse_lookups_and_configs():
    assert cs.sparse_lookups("linear", cs.SPARSE_LINEAR) == 8192 * 32
    assert cs.sparse_lookups("mf", cs.SPARSE_MF) == 128
    mib = (cs.SPARSE_MF["users"] + cs.SPARSE_MF["items"]) \
        * cs.SPARSE_MF["factor"] * 4 / 2 ** 20
    assert abs(mib - 66.75) < 0.01
    n = cs.SPARSE_LINEAR["features"]
    expected = n * (1 - np.exp(-8192 * 32 / n))
    assert 230_000 < expected < 231_000
