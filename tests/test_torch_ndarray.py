"""The port's NDArray runtime (`mxnet_tpu_torch.ndarray`, `context`,
`base`) held to the JAX package's on the CPU: creation, the arithmetic and
comparison operators, indexing and writes, contexts, and `nd.save` /
`nd.load`, whose files cross between the packages bit for bit.

Values agree exactly: every case is a copy, an integer result or one fp32
operation on both sides.
"""
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError, np_dtype, torch_dtype
from mxnet_tpu_torch.ndarray.utils import CorruptCheckpointError

CPU = mx.cpu()


def _both(fn):
    """fn(package, ctx) on the port (on the CPU) and on the JAX package."""
    return fn(mx, CPU), fn(jmx, jmx.cpu())


def _same(got, want):
    got, want = np.asarray(got.asnumpy()), np.asarray(want.asnumpy())
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_import_surface_and_default_context():
    for name in ("nd", "ndarray", "autograd", "random", "cpu", "gpu",
                 "current_context", "Context", "MXNetError"):
        assert hasattr(mx, name), name
    assert mx.current_context() == mx.gpu(0)
    with mx.cpu():
        assert mx.current_context() == CPU
        assert mx.nd.ones((2,)).context == CPU
    assert mx.current_context() == mx.gpu(0)
    assert mx.cpu().torch_device == torch.device("cpu")
    with pytest.raises(MXNetError, match="gpu"):
        mx.tpu()
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            mx.nd.ones((2,))
        with pytest.raises(MXNetError):
            mx.nd.array([1.0, 2.0])
    assert mx.nd.ones((2, 3), ctx=CPU).shape == (2, 3)
    assert str(mx.gpu(1)) == "gpu(1)" and mx.gpu(1) != mx.gpu(0)


@pytest.mark.parametrize("make", [
    lambda nd, c: nd.array([[1, 2], [3, 4]], ctx=c),
    lambda nd, c: nd.array(np.arange(6.0).reshape(2, 3), ctx=c),
    lambda nd, c: nd.array([1.5, 2.5], ctx=c, dtype="float16"),
    lambda nd, c: nd.zeros((2, 3), ctx=c, dtype="int32"),
    lambda nd, c: nd.ones((3,), ctx=c),
    lambda nd, c: nd.full((2, 2), 7.5, ctx=c),
    lambda nd, c: nd.empty((2, 2), ctx=c),
    lambda nd, c: nd.arange(2, 11, 3, ctx=c),
    lambda nd, c: nd.arange(0, 2, 0.5, repeat=2, ctx=c),
    lambda nd, c: nd.eye(3, 4, 1, ctx=c),
    lambda nd, c: nd.linspace(0, 1, 5, ctx=c),
], ids=["int_list", "float64_source", "float16", "zeros_int32", "ones",
        "full", "empty", "arange", "arange_repeat", "eye", "linspace"])
def test_creation_matches_jax(make):
    got, want = make(mx.nd, CPU), make(jmx.nd, jmx.cpu())
    _same(got, want)


def test_dtype_tables():
    from mxnet_tpu import base as jbase
    from mxnet_tpu_torch import base

    for flag, t in base._DTYPE_MX_TO_NP.items():
        assert jbase._DTYPE_MX_TO_NP[flag] == t
    assert np_dtype(None) == np.float32 and np_dtype("bfloat16") is \
        torch.bfloat16
    assert np_dtype(torch.int64) == np.int64
    assert torch_dtype("float16") == torch.float16
    x = mx.nd.ones((2,), ctx=CPU, dtype="bfloat16")
    assert x.dtype is torch.bfloat16 and x.asnumpy().dtype == np.float32


OPERATORS = {
    "add": lambda a, b: a + b, "radd": lambda a, b: 2 + a,
    "sub": lambda a, b: a - b, "rsub": lambda a, b: 1.5 - a,
    "mul": lambda a, b: a * 3, "div": lambda a, b: a / b,
    "rdiv": lambda a, b: 2.0 / b, "mod": lambda a, b: a % 1.5,
    "rmod": lambda a, b: 7.0 % b, "pow": lambda a, b: b ** 2,
    "rpow": lambda a, b: 2 ** a, "neg": lambda a, b: -a,
    "abs": lambda a, b: abs(a), "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != 2.0, "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= 1.0, "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b, "broadcast": lambda a, b: a[:1] * b,
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operators_match_jax(name):
    a = np.array([[1.0, -2.0, 3.0], [0.5, 2.0, -1.0]], np.float32)
    b = np.array([[2.0, 2.0, 1.0], [0.5, 4.0, 3.0]], np.float32)

    def run(pkg, ctx):
        return OPERATORS[name](pkg.nd.array(a, ctx=ctx),
                               pkg.nd.array(b, ctx=ctx))

    _same(*_both(run))


def test_inplace_operators_and_fluent_methods():
    def run(pkg, ctx):
        x = pkg.nd.array(np.arange(12.0).reshape(3, 4), ctx=ctx)
        x += 1
        x -= 0.5
        x *= 2
        x /= 4
        return [x, x.reshape((2, -1)), x.T, x.sum(axis=1), x.mean(),
                x.max(axis=0, keepdims=True), x.argmax(axis=1),
                x.expand_dims(0), x.flatten(), x.clip(1, 3),
                x.astype("int32"), x.slice_axis(1, 1, 3), x.tile((1, 2)),
                x.split(2, axis=1)[1], x.topk(k=2), x.sort(axis=0,
                                                           is_ascend=False),
                x.norm(), x.square().sqrt(), x.swapaxes(0, 1),
                x.take(pkg.nd.array([0, 2], ctx=ctx)),
                x.pick(pkg.nd.array([0, 1, 3], ctx=ctx)),
                x.one_hot(3), x.broadcast_to((2, 3, 4)), x.copy(),
                x.softmax(), x.log_softmax(axis=0), x.relu(), x.sigmoid()]

    got, want = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6)
        assert g.asnumpy().dtype == w.asnumpy().dtype


RESHAPES = [((2, 3, 4), (4, 0, -1), False), ((2, 3, 4), (-2,), False),
            ((2, 3, 4), (-3, 4), False), ((2, 3, 4), (-4, 1, 2, -2), False),
            ((2, 3, 4), (0, -4, -1, 3, 4), False),
            ((2, 3, 4), (-1, 0), True), ((2, 3, 4), (0, -1), True)]


@pytest.mark.parametrize("src,target,reverse", RESHAPES)
def test_reshape_special_codes(src, target, reverse):
    from mxnet_tpu.ops.shape_ops import infer_reshape as jax_infer
    from mxnet_tpu_torch.ops.shape_ops import infer_reshape

    want = jax_infer(src, target, reverse)
    assert infer_reshape(src, target, reverse) == want
    x = mx.nd.ones(src, ctx=CPU).reshape(target, reverse=reverse)
    assert x.shape == want


KEYS = [1, -1, slice(1, 3), (slice(None), 2), (1, slice(None, None, 2)),
        (slice(None, None, -1),), (0, 1), np.array([2, 0]),
        (slice(None), np.array([True, False, True, False]))]


@pytest.mark.parametrize("key", KEYS, ids=[repr(k) for k in KEYS])
def test_getitem_and_setitem_match_jax(key):
    base = np.arange(12.0, dtype=np.float32).reshape(3, 4)

    def run(pkg, ctx):
        x = pkg.nd.array(base, ctx=ctx)
        read = x[key]
        y = pkg.nd.array(base, ctx=ctx)
        y[key] = -1.0
        z = pkg.nd.array(base, ctx=ctx)
        z[key] = pkg.nd.array(np.full(base[key].shape, 9.0, np.float32),
                              ctx=ctx)
        return [read, y, z]

    for g, w in zip(*_both(run)):
        _same(g, w)


def test_writes_rebind_and_never_touch_other_arrays():
    x = mx.nd.array(np.zeros(4, np.float32), ctx=CPU)
    view = x[1:3]
    before = x._data
    x[:] = 1.0
    x[1] = 5.0
    assert x._data is not before
    np.testing.assert_array_equal(view.asnumpy(), [0.0, 0.0])
    np.testing.assert_array_equal(x.asnumpy(), [1.0, 5.0, 1.0, 1.0])
    w, g, m = (mx.nd.ones((3,), ctx=CPU) for _ in range(3))
    mom = m._data
    mx.nd.sgd_mom_update(w, g, m, lr=0.5, momentum=0.9, out=w)
    assert m._data is mom  # an aux state is written in place
    np.testing.assert_allclose(m.asnumpy(), 0.9 - 0.5)
    np.testing.assert_allclose(w.asnumpy(), 1.4)
    # sparse storage is ported (slice 15): a row_sparse zeros holds no row
    z = mx.nd.zeros((2,), ctx=CPU, stype="row_sparse")
    assert z.stype == "row_sparse" and z.indices.shape == (0,)
    assert not z.densified()


def test_context_moves_and_pickle():
    x = mx.nd.array([[1.0, 2.0]], ctx=CPU)
    assert x.as_in_context(CPU) is x
    y = mx.nd.zeros((1, 2), ctx=CPU)
    x.copyto(y)
    np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())
    z = pickle.loads(pickle.dumps(x))
    np.testing.assert_array_equal(z.asnumpy(), x.asnumpy())
    assert float(mx.nd.array([3.0], ctx=CPU).asscalar()) == 3.0
    x.wait_to_read()
    mx.nd.waitall()


# -- nd.save / nd.load -------------------------------------------------------

SAVED = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
         "h": np.array([1.5, -2.25], np.float16),
         "i": np.array([[7, -8]], np.int32),
         "u": np.array([0, 255], np.uint8),
         "b": np.array([1, -1], np.int8),
         "s": np.array(3.5, np.float32)}


def _strip_footers(data, n):
    """The version-0 (reference) layout of a version-1 file: version word 0
    and no CRC footer after each payload."""
    out = bytearray(data[:24])
    out[8:16] = struct.pack("<Q", 0)
    pos = 24
    for _ in range(n):
        flag, ndim = struct.unpack("<iI", data[pos:pos + 8])
        shape = struct.unpack(f"<{ndim}q", data[pos + 8:pos + 8 + 8 * ndim])
        head = 8 + 8 * ndim
        size = int(np.prod(shape)) * np.dtype(
            {0: np.float32, 2: np.float16, 3: np.uint8, 4: np.int32,
             5: np.int8}[flag]).itemsize
        out += data[pos:pos + head + size]
        pos += head + size + 12
    return bytes(out + data[pos:])


@pytest.mark.parametrize("form", ["dict", "list"])
def test_save_load_cross_package_bit_equal(tmp_path, form):
    names = sorted(SAVED)
    port = {k: mx.nd.array(SAVED[k], ctx=CPU, dtype=SAVED[k].dtype)
            for k in names}
    jax = {k: jmx.nd.array(SAVED[k], dtype=SAVED[k].dtype) for k in names}
    p_file, j_file = tmp_path / "port.params", tmp_path / "jax.params"
    mx.nd.save(str(p_file), port if form == "dict" else
               [port[k] for k in names])
    jmx.nd.save(str(j_file), jax if form == "dict" else
                [jax[k] for k in names])
    jmx.nd.load(str(j_file))  # waits for the JAX package's writer
    assert p_file.read_bytes() == j_file.read_bytes()
    v0 = tmp_path / "v0.params"
    v0.write_bytes(_strip_footers(j_file.read_bytes(), len(names)))
    for path in (p_file, j_file, v0):
        for load, ctx in ((mx.nd.load, {"ctx": CPU}), (jmx.nd.load, {})):
            got = load(str(path), **ctx)
            if form == "list":
                got = dict(zip(names, got))
            assert sorted(got) == names
            for k in names:
                a = got[k].asnumpy()
                assert a.dtype == SAVED[k].dtype and a.shape == \
                    SAVED[k].shape
                assert a.tobytes() == SAVED[k].tobytes(), (path, k)


def test_save_bfloat16_as_float32_and_corrupt_files(tmp_path):
    path = str(tmp_path / "bf16.params")
    x = mx.nd.array([1.0, 2.5, -3.0], ctx=CPU, dtype="bfloat16")
    mx.nd.save(path, x)
    for load in (lambda p: mx.nd.load(p, ctx=CPU), jmx.nd.load):
        (back,) = load(path)
        assert back.asnumpy().dtype == np.float32
        np.testing.assert_array_equal(back.asnumpy(), [1.0, 2.5, -3.0])
    data = open(path, "rb").read()
    short = str(tmp_path / "short.params")
    with open(short, "wb") as f:
        f.write(data[:-9])
    with pytest.raises(CorruptCheckpointError, match="truncated"):
        mx.nd.load(short, ctx=CPU)
    flipped = bytearray(data)
    flipped[40] ^= 1  # a payload byte: the CRC footer no longer matches
    bad = str(tmp_path / "bad.params")
    with open(bad, "wb") as f:
        f.write(bytes(flipped))
    with pytest.raises(CorruptCheckpointError, match="CRC"):
        mx.nd.load(bad, ctx=CPU)
    os.environ["MXNET_CHECKPOINT_VERIFY"] = "0"
    try:
        assert len(mx.nd.load(bad, ctx=CPU)) == 1
    finally:
        del os.environ["MXNET_CHECKPOINT_VERIFY"]
    with open(bad, "wb") as f:
        f.write(b"\0" * 24)
    with pytest.raises(MXNetError, match="Invalid NDArray file"):
        mx.nd.load(bad, ctx=CPU)
