"""NDArray, the framework's value type: the port of
`mxnet_tpu/ndarray/ndarray.py`.

An NDArray wraps one `torch.Tensor`; its context is the tensor's device.
Ops run eagerly on the tensor's device, asynchronously on a CUDA card, and
`wait_to_read` synchronizes. A write (``x[k] = v``, ``x += y``, ``out=``)
rebinds the NDArray to a new tensor, as the JAX package swaps its buffer:
a tensor that a recorded graph saved is never modified. Only the trailing
outputs of ops with ``mutate_aux`` (BatchNorm's moving stats, optimizer
states) are copied into their NDArrays' tensors in place. Basic slices and
some shape ops return views that share storage with their source, as in
the reference (the JAX package's are copies); since writes rebind, a view
changes only when an aux write lands in its source.

The sparse storage types (``row_sparse``, ``csr``) are subclasses in
`ndarray/sparse.py`; `tostype`, ``attach_grad(stype=)`` and
``zeros(stype=)`` reach them. Not ported: lazy capture (`MXNET_LAZY`,
ROADMAP.md queue A).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import (MXNetError, integer_types, np_dtype, numeric_types,
                    torch_dtype)
from ..context import Context, context_of, current_context
from ..ops.shape_ops import write_key

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "waitall"]


class NDArray:
    __slots__ = ("_data", "grad", "grad_req", "_ag_marked", "_fresh_grad",
                 "__weakref__")

    def __init__(self, data, ctx=None, stype="default"):
        # ``stype`` is the reference's argument: an NDArray is dense, the
        # sparse types are the subclasses of `ndarray/sparse.py`
        if ctx is not None and data.device != ctx.torch_device:
            data = data.to(ctx.torch_device)
        self._data = data
        self.grad = None
        self.grad_req = "null"
        self._ag_marked = False
        # True once backward() has written this array's grad
        self._fresh_grad = False

    # -- basic properties ---------------------------------------------------

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def context(self):
        return context_of(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def handle(self):
        return self._data

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        shape = "x".join(map(str, self.shape))
        return f"\n{self.asnumpy()}\n<NDArray {shape} @{self.context}>"

    __str__ = __repr__

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError(
            "The truth value of an NDArray with multiple elements is "
            "ambiguous.")

    # -- conversion ---------------------------------------------------------

    def asnumpy(self):
        """Blocking copy to the host. bfloat16, which numpy lacks, comes
        back as float32. Always a copy: the arrays bound by an executor are
        written in place later."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def astype(self, dtype, copy=True):
        if not copy and np_dtype(dtype) == self.dtype:
            return self
        return _invoke("Cast", self, dtype=dtype)

    def as_in_context(self, ctx):
        """This array on ``ctx`` (itself if it is there). A copy from
        page-locked host memory (a `DataLoader` batch with ``pin_memory``)
        does not block the host: it is ordered on the current stream."""
        if ctx == self.context:
            return self
        t = self._data.detach()
        return NDArray(t.to(ctx.torch_device, non_blocking=not t.is_cuda
                            and t.is_pinned()))

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._rebind(self._data.detach().to(other._data.device,
                                                 other._data.dtype))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        raise TypeError(f"copyto does not support type {type(other)}")

    def copy(self):
        return NDArray(self._data.detach().clone())

    def tostype(self, stype):
        """This array in storage type ``stype`` (parity `ndarray.py:166`):
        itself for ``default``, else a new sparse array."""
        if stype in (None, "default"):
            return self
        from . import sparse

        return sparse.cast_storage(self, stype)

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    # -- writes -------------------------------------------------------------

    def _rebind(self, t):
        """Make ``t`` this array's value: the write behind ``out=``,
        ``__setitem__`` and the in-place operators. Outside recording a
        marked array stays a leaf that requires grad."""
        from .. import autograd

        if t.dtype != self._data.dtype or t.device != self._data.device:
            t = t.to(self._data.device, self._data.dtype)
        self._data = t
        if not autograd.is_recording():
            if self._ag_marked:
                autograd._make_leaf(self)
            else:
                self._data = t.detach()

    # -- autograd -----------------------------------------------------------

    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer and mark the array for `backward`.
        ``stype="row_sparse"`` allocates a row-sparse buffer with no row:
        a row-sparse gradient (Embedding's ``sparse_grad``) is then
        deposited as (indices, rows), never densified."""
        from .. import autograd

        if stype == "row_sparse":
            from . import sparse

            t = self._data
            buf = sparse.zeros("row_sparse", self.shape, dtype=t.dtype,
                               ctx=self.context)
        elif stype in (None, "default"):
            buf = NDArray(torch.zeros_like(self._data.detach()))
        else:
            raise MXNetError(f"attach_grad: a {stype!r} gradient buffer is "
                             "not supported (row_sparse or default)")
        autograd.mark_variables([self], [buf], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    # -- fluent methods (parity `ndarray.py:216-358`) -----------------------

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape")
        return _invoke("Reshape", self, shape=shape,
                       reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return _invoke("Reshape", self, shape=other.shape)

    def expand_dims(self, axis):
        return _invoke("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return _invoke("squeeze", self, axis=axis)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _invoke("transpose", self, axes=axes if axes else None)

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return _invoke("Flatten", self)

    def flip(self, axis):
        return _invoke("reverse", self, axis=axis)

    def tile(self, reps):
        return _invoke("tile", self, reps=reps)

    def repeat(self, repeats, axis=None):
        return _invoke("repeat", self, repeats=repeats, axis=axis)

    def swapaxes(self, dim1, dim2):
        return _invoke("SwapAxis", self, dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke("SliceChannel", self, num_outputs=num_outputs,
                       axis=axis, squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=None):
        return _invoke("slice", self, begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _invoke("take", self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return _invoke("pick", self, index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return _invoke("one_hot", self, depth=depth, on_value=on_value,
                       off_value=off_value, dtype=dtype)

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", self, shape=shape)

    def broadcast_like(self, other):
        return _invoke("broadcast_like", self, other)

    def diag(self, k=0):
        return _invoke("diag", self, k=k)

    def sum(self, axis=None, keepdims=False, **kw):
        return _invoke("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return _invoke("mean", self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return _invoke("prod", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return _invoke("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return _invoke("min", self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _invoke("argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _invoke("argmin", self, axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return _invoke("argsort", self, axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return _invoke("sort", self, axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _invoke("topk", self, axis=axis, k=k, ret_typ=ret_typ,
                       is_ascend=is_ascend)

    def clip(self, a_min, a_max):
        return _invoke("clip", self, a_min=a_min, a_max=a_max)

    def abs(self):
        return _invoke("abs", self)

    def sign(self):
        return _invoke("sign", self)

    def exp(self):
        return _invoke("exp", self)

    def log(self):
        return _invoke("log", self)

    def sqrt(self):
        return _invoke("sqrt", self)

    def square(self):
        return _invoke("square", self)

    def sigmoid(self):
        return _invoke("sigmoid", self)

    def tanh(self):
        return _invoke("tanh", self)

    def relu(self):
        return _invoke("relu", self)

    def softmax(self, axis=-1):
        return _invoke("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return _invoke("log_softmax", self, axis=axis)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke("dot", self, other, transpose_a=transpose_a,
                       transpose_b=transpose_b)

    def as_nd_ndarray(self):
        return self

    # -- arithmetic (parity `ndarray.py:364-456`) ---------------------------

    def _binary(self, other, op, scalar_op):
        if isinstance(other, NDArray):
            return _invoke(op, self, other)
        if isinstance(other, numeric_types):
            return _invoke(scalar_op, self, scalar=float(other))
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return _invoke("_rminus_scalar", self, scalar=float(o))

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return _invoke("_rdiv_scalar", self, scalar=float(o))

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return _invoke("_rmod_scalar", self, scalar=float(o))

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return _invoke("_rpower_scalar", self, scalar=float(o))

    def __neg__(self):
        return _invoke("negative", self)

    def __abs__(self):
        return _invoke("abs", self)

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __iadd__(self, o):
        self._rebind(self.__add__(o)._data)
        return self

    def __isub__(self, o):
        self._rebind(self.__sub__(o)._data)
        return self

    def __imul__(self, o):
        self._rebind(self.__mul__(o)._data)
        return self

    def __itruediv__(self, o):
        self._rebind(self.__truediv__(o)._data)
        return self

    # -- indexing (parity `ndarray.py:458-640`) -----------------------------

    def __getitem__(self, key):
        """A read through torch indexing; under `record()` a node of the
        graph, so gradients scatter back into the source. An NDArray key
        indexes as integers."""
        return _invoke("_ag_getitem", self, key=(_convert_index(key),))

    def __setitem__(self, key, value):
        """``x[key] = value``: x is rebound to a copy with the window
        written, recorded under `record()` so that gradients flow both to
        the value and around the window, and with a marked x's gradient
        taken at the value recording first saw."""
        from .. import autograd

        if autograd.is_recording():
            autograd._note_input(self)
            if isinstance(value, NDArray):
                autograd._note_input(value)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, numeric_types):
            value = torch.as_tensor(_np.asarray(value))
        with torch.set_grad_enabled(autograd.is_recording()):
            new = write_key(self._data, _convert_index(key), value)
        self._rebind(new)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    # -- serialization ------------------------------------------------------

    def __getstate__(self):
        return {"data": self.asnumpy(), "dtype": str(self._data.dtype)}

    def __setstate__(self, state):
        self._data = torch.from_numpy(state["data"]).to(
            getattr(torch, state["dtype"].split(".")[-1]))
        self.grad, self.grad_req = None, "null"
        self._ag_marked = self._fresh_grad = False

    def save(self, fname):
        from .utils import save

        save(fname, self)


def _convert_index(key):
    if isinstance(key, NDArray):
        return key._data.long()
    if isinstance(key, tuple):
        return tuple(_convert_index(k) for k in key)
    if isinstance(key, _np.ndarray):
        return torch.from_numpy(key).long() if key.dtype != _np.bool_ \
            else torch.from_numpy(key)
    return key


def _invoke(op_name, *args, **kwargs):
    from .register import invoke_nd

    return invoke_nd(op_name, *args, **kwargs)


# ---------------------------------------------------------------------------
# creation helpers (parity: python/mxnet/ndarray/utils.py + ndarray.py)
# ---------------------------------------------------------------------------


def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device


def array(source_array, ctx=None, dtype=None):
    """An NDArray from a numpy array, a nested list or an NDArray. Unless
    ``dtype`` says otherwise, a float64 source becomes float32 and an int64
    source int32, as in the JAX package."""
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
        dtype = dtype or src.dtype
        return NDArray(src.to(_device(ctx), torch_dtype(dtype), copy=True))
    src = _np.asarray(source_array)
    if dtype is None:
        dtype = {_np.dtype(_np.float64): _np.float32,
                 _np.dtype(_np.int64): _np.int32}.get(src.dtype, src.dtype)
    dt = torch_dtype(dtype)
    if dt == torch.bfloat16:
        src = src.astype(_np.float32)
    t = torch.from_numpy(_np.array(src, order="C", copy=True))
    return NDArray(t.to(_device(ctx), dt))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, stype=None, **kwargs):
    if stype not in (None, "default"):
        from . import sparse

        return sparse.zeros(stype, shape, ctx=ctx, dtype=dtype)
    return NDArray(torch.zeros(_shape_t(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape_t(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.full(_shape_t(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, infer_range=False, ctx=None,
           dtype="float32"):
    return _invoke("_arange", start=start, stop=stop, step=step,
                   repeat=repeat, dtype=dtype, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    return _invoke("Concat", *arrays, dim=axis, num_args=len(arrays))


def _shape_t(shape):
    if isinstance(shape, integer_types):
        return (int(shape),)
    return tuple(int(s) for s in shape)


_PY_SCALAR_FN = {
    "broadcast_add": lambda a, b: a + b, "broadcast_sub": lambda a, b: a - b,
    "broadcast_mul": lambda a, b: a * b, "broadcast_div": lambda a, b: a / b,
    "broadcast_mod": lambda a, b: a % b,
    "broadcast_power": lambda a, b: a ** b,
    "broadcast_maximum": max, "broadcast_minimum": min,
    "broadcast_hypot": lambda a, b: (a * a + b * b) ** 0.5,
    "broadcast_equal": lambda a, b: float(a == b),
    "broadcast_not_equal": lambda a, b: float(a != b),
    "broadcast_greater": lambda a, b: float(a > b),
    "broadcast_greater_equal": lambda a, b: float(a >= b),
    "broadcast_lesser": lambda a, b: float(a < b),
    "broadcast_lesser_equal": lambda a, b: float(a <= b),
}


def _ufunc_helper(lhs, rhs, fn_array, fn_scalar, rfn_scalar=None):
    """Dispatch array/scalar combinations (parity `ndarray.py _ufunc_helper`)."""
    if isinstance(lhs, numeric_types):
        if isinstance(rhs, numeric_types):
            return _PY_SCALAR_FN[fn_array](lhs, rhs)
        return _invoke(rfn_scalar or fn_scalar, rhs, scalar=float(lhs))
    if isinstance(rhs, numeric_types):
        return _invoke(fn_scalar, lhs, scalar=float(rhs))
    return _invoke(fn_array, lhs, rhs)


def maximum(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_maximum", "_maximum_scalar")


def minimum(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_minimum", "_minimum_scalar")


def power(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_power", "_power_scalar",
                         "_rpower_scalar")


def hypot(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_hypot", "_hypot_scalar")


def add(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_add", "_plus_scalar")


def subtract(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_sub", "_minus_scalar",
                         "_rminus_scalar")


def multiply(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_mul", "_mul_scalar")


def divide(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_div", "_div_scalar",
                         "_rdiv_scalar")


def modulo(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_mod", "_mod_scalar",
                         "_rmod_scalar")


def equal(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_equal", "_equal_scalar")


def not_equal(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_not_equal", "_not_equal_scalar")


def greater(lhs, rhs):
    # a scalar lhs mirrors to the opposite comparison: 2 > x == x < 2
    return _ufunc_helper(lhs, rhs, "broadcast_greater", "_greater_scalar",
                         "_lesser_scalar")


def greater_equal(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_greater_equal",
                         "_greater_equal_scalar", "_lesser_equal_scalar")


def lesser(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_lesser", "_lesser_scalar",
                         "_greater_scalar")


def lesser_equal(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_lesser_equal",
                         "_lesser_equal_scalar", "_greater_equal_scalar")


def true_divide(lhs, rhs):
    return divide(lhs, rhs)


def waitall():
    """Block until all queued work on every card is done."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def moveaxis(tensor, source, destination):
    return NDArray(torch.movedim(tensor._data, source, destination))


def onehot_encode(indices, out):
    out._rebind(_invoke("one_hot", indices, depth=out.shape[1])._data)
    return out
