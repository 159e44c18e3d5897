"""The port's sparse NDArrays (`mxnet_tpu_torch.ndarray.sparse`) held to the
JAX package's on the CPU, from the same numpy arrays: the constructors,
`cast_storage` both ways, `retain`, `add`, `square_sum`, the csr `dot` and
its transpose, `tostype`, `zeros(stype=)`, ``attach_grad(stype=)``, the
lazy dense view (`densified`), `kvstore.row_sparse_pull` (the port of
`test_kvstore.py::test_row_sparse_pull`) and `LibSVMIter` (the port of
`test_io.py::test_libsvm_iter`).

Index sets (indices, indptr) are compared exactly, with their dtype
(int32, as the JAX package reports them); values within rtol 1e-6 /
atol 1e-7 (fp32 sums in another order).
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch import kvstore as kvs
from mxnet_tpu_torch.ndarray import sparse as sp

CPU = mx.cpu()
TOL = {"rtol": 1e-6, "atol": 1e-7}


def _dense(seed=0, shape=(7, 5), density=0.4):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    a[rng.uniform(size=shape) > density] = 0
    a[2] = 0  # an empty row
    return a


def _components(arr):
    """{name: numpy} of a sparse array of either package."""
    names = ("data", "indices") + (("indptr",) if arr.stype == "csr" else ())
    return {n: getattr(arr, n).asnumpy() for n in names}


def _same_components(got, want):
    g, w = _components(got), _components(want)
    assert sorted(g) == sorted(w)
    for name in w:
        if name == "data":
            np.testing.assert_allclose(g[name], w[name], **TOL)
        else:
            assert g[name].dtype == np.int32, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert got.shape == want.shape and got.stype == want.stype


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_cast_storage_both_ways(stype):
    a = _dense()
    got = mx.nd.cast_storage(mx.nd.array(a, ctx=CPU), stype)
    want = jmx.nd.cast_storage(jmx.nd.array(a), stype)
    assert isinstance(got, sp.BaseSparseNDArray)
    assert not got.densified()
    _same_components(got, want)
    back = mx.nd.cast_storage(got, "default")
    assert type(back) is mx.nd.NDArray
    np.testing.assert_array_equal(back.asnumpy(), a)
    assert got.tostype(stype) is got


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_tostype_and_the_lazy_view(stype):
    a = _dense(1)
    got = mx.nd.array(a, ctx=CPU).tostype(stype)
    assert got.shape == a.shape and got.dtype == np.float32
    assert got.context == CPU and got.ndim == 2 and got.size == a.size
    assert not got.densified()  # metadata and components only
    np.testing.assert_array_equal(got.asnumpy(), a)
    assert got.densified()
    np.testing.assert_array_equal(got.tostype("default").asnumpy(), a)


def test_row_sparse_array_from_components():
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = mx.nd.sparse.row_sparse_array((data, [1, 4]), shape=(6, 3),
                                        ctx=CPU)
    want = jsp.row_sparse_array((data, [1, 4]), shape=(6, 3))
    _same_components(got, want)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_csr_matrix_from_components():
    args = ([1.0, 2.0, 3.0], [1, 0, 2], [0, 1, 1, 3])
    got = mx.nd.sparse.csr_matrix(args, shape=(3, 4), ctx=CPU)
    want = jsp.csr_matrix(args, shape=(3, 4))
    _same_components(got, want)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_zeros(stype):
    got = mx.nd.zeros((5, 3), ctx=CPU, stype=stype)
    want = jsp.zeros(stype, (5, 3))
    assert got.stype == stype and got.shape == (5, 3)
    if stype != "default":
        assert not got.densified()
        _same_components(got, want)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("rows", [[0, 4], [3, 3, 6], [2], []],
                         ids=["two", "duplicates", "an_empty_row", "none"])
def test_retain(rows):
    a = _dense(2)
    got = mx.nd.sparse_retain(mx.nd.array(a, ctx=CPU).tostype("row_sparse"),
                              mx.nd.array(rows, ctx=CPU, dtype="int64"))
    want = jmx.nd.sparse_retain(jmx.nd.array(a).tostype("row_sparse"),
                                jmx.nd.array(rows, dtype="int64"))
    assert isinstance(got, sp.RowSparseNDArray) and not got.densified()
    _same_components(got, want)
    # the dense op keeps the same rows
    dense = mx.nd.sparse_retain(mx.nd.array(a, ctx=CPU),
                                mx.nd.array(rows, ctx=CPU, dtype="int64"))
    np.testing.assert_array_equal(dense.asnumpy(), want.asnumpy())


def test_add_is_the_union_of_rows():
    a, b = _dense(3), _dense(4)
    got = mx.nd.array(a, ctx=CPU).tostype("row_sparse") + \
        mx.nd.array(b, ctx=CPU).tostype("row_sparse")
    want = jsp.add(jmx.nd.array(a).tostype("row_sparse"),
                   jmx.nd.array(b).tostype("row_sparse"))
    assert isinstance(got, sp.RowSparseNDArray) and not got.densified()
    _same_components(got, want)
    np.testing.assert_allclose(got.asnumpy(), a + b, **TOL)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (None, True),
                                           (1, False), (-1, True)])
def test_square_sum(axis, keepdims):
    a = _dense(5)
    x = mx.nd.array(a, ctx=CPU).tostype("row_sparse")
    got = sp.square_sum(x, axis=axis, keepdims=keepdims)
    want = jsp.square_sum(jmx.nd.array(a).tostype("row_sparse"), axis=axis,
                          keepdims=keepdims)
    assert not x.densified()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot(transpose_a):
    """Against the dense `dot` of both packages: the JAX package's csr dot
    jits its segment sum with the row count traced, which raises on that
    side (`mxnet_tpu/ndarray/sparse.py:371`)."""
    a = _dense(6, (6, 9))
    rhs = np.random.RandomState(7).uniform(
        -1, 1, (6 if transpose_a else 9, 4)).astype(np.float32)
    lhs = mx.nd.array(a, ctx=CPU).tostype("csr")
    got = sp.dot(lhs, mx.nd.array(rhs, ctx=CPU), transpose_a=transpose_a)
    want = jmx.nd.dot(jmx.nd.array(a), jmx.nd.array(rhs),
                      transpose_a=transpose_a)
    assert not lhs.densified()
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.asnumpy(),
                               (a.T if transpose_a else a) @ rhs, rtol=1e-5,
                               atol=1e-6)


def test_row_sparse_copy_astype_and_zero_reset():
    x = mx.nd.array(_dense(8), ctx=CPU).tostype("row_sparse")
    y = x.astype("float16")
    assert isinstance(y, sp.RowSparseNDArray) and y.dtype == np.float16
    np.testing.assert_array_equal(y.indices.asnumpy(), x.indices.asnumpy())
    z = x.copy()
    z[:] = 0  # empties the components, never a dense zeros(table)
    assert not z.densified() and z.indices.shape == (0,)
    assert z.data.shape == (0, 5) and z.shape == x.shape
    assert x.indices.shape[0] > 0  # the copy owns its components
    np.testing.assert_array_equal(z.asnumpy(), np.zeros((7, 5), np.float32))


def test_a_dense_write_resparsifies():
    x = mx.nd.zeros((4, 2), ctx=CPU, stype="row_sparse")
    x[1] = 3.0  # the dense fallback: the components follow the write
    np.testing.assert_array_equal(x.indices.asnumpy(), [1])
    np.testing.assert_array_equal(x.data.asnumpy(), [[3.0, 3.0]])


def test_attach_grad_row_sparse():
    x = mx.nd.array(_dense(9), ctx=CPU)
    x.attach_grad(stype="row_sparse")
    assert isinstance(x.grad, sp.RowSparseNDArray)
    assert x.grad.shape == x.shape and x.grad.indices.shape == (0,)
    x.attach_grad()
    assert type(x.grad) is mx.nd.NDArray


def _pull_store(value):
    kv = kvs.create("local")
    kv.init("emb", torch.from_numpy(value))
    return kv


@pytest.mark.parametrize("out_kind", ["ndarray", "tensor", "row_sparse"])
def test_row_sparse_pull(out_kind):
    """The reference's PullRowSparseImpl contract: the full logical shape,
    the requested rows (deduplicated) filled, every other row zero; a
    row_sparse out gets just those rows."""
    w = np.random.RandomState(10).rand(6, 4).astype("float32")
    rid = np.array([0, 2, 5, 2], dtype="int64")
    kv = _pull_store(w)
    out = {"ndarray": mx.nd.zeros((6, 4), ctx=CPU),
           "tensor": torch.zeros(6, 4),
           "row_sparse": mx.nd.zeros((6, 4), ctx=CPU,
                                     stype="row_sparse")}[out_kind]
    kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array(rid, ctx=CPU))
    jkv = jmx.kvstore.create("local")
    jkv.init("emb", jmx.nd.array(w))
    jout = jmx.nd.zeros((6, 4))
    jkv.row_sparse_pull("emb", out=jout, row_ids=jmx.nd.array(rid))
    got = out.numpy() if out_kind == "tensor" else out.asnumpy()
    np.testing.assert_array_equal(got, jout.asnumpy())
    expected = np.zeros_like(w)
    expected[[0, 2, 5]] = w[[0, 2, 5]]
    np.testing.assert_array_equal(got, expected)
    if out_kind == "row_sparse":
        np.testing.assert_array_equal(out.indices.asnumpy(), [0, 2, 5])


def test_libsvm_iter():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "data.svm")
        with open(path, "w") as f:
            f.write("1 0:1.5 3:2.0\n0 1:1.0\n1 2:3.0\n0 0:0.5\n")
        with CPU:
            got = list(mx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                                        batch_size=2))
        want = list(jmx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                                      batch_size=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data[0].asnumpy(),
                                      w.data[0].asnumpy())
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())
    np.testing.assert_allclose(got[0].data[0].asnumpy(),
                               [[1.5, 0, 0, 2.0], [0, 1.0, 0, 0]])
