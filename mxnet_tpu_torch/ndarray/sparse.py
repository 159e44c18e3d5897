"""Sparse NDArrays, row_sparse and csr: the port of
`mxnet_tpu/ndarray/sparse.py` (parity `python/mxnet/ndarray/sparse.py`
over the reference's storage types, `include/mxnet/ndarray.h:61-66`, and
its sparse kernels `cast_storage-inl.h`, `dot.cc`, `sparse_retain.cc`,
`square_sum.cc`).

Compound storage is the reference's aux-data layout held as dense tensors:
(data, indices) for row_sparse, (data, indices, indptr) for csr. Indices
and indptr are int32, as the JAX package reports them; they widen to int64
only where a torch index op needs it. The logically dense view is lazy:
nothing builds the full array until a dense-only path reads ``_data`` (the
storage-fallback rule of `attach_op_execs_pass.cc:46`), and `shape`,
`dtype` and `context` come from metadata, so a 1,000,001-row row_sparse
gradient goes through backward, retain and the optimizer's lazy update
without the dense matrix ever being allocated. `densified` tells whether
it was.

Sparse ops are torch gather, scatter and `unique` calls on the components.
On a card, `unique`, `nonzero` and `isin` size their outputs from the data,
so each waits for the card once (the JAX package's eager path has the same
shape-from-data structure).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import context_of
from .ndarray import NDArray, array as _dense_array, zeros as _dense_zeros

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray", "zeros",
           "array", "row_sparse_array", "csr_matrix", "cast_storage",
           "retain", "dot", "square_sum", "add", "unique_rows",
           "fill_rows"]


def _tensor(x, dtype=None, device=None):
    """The tensor of an NDArray, a tensor or an array-like, detached."""
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        t = torch.as_tensor(_np.asarray(x))
    if dtype is not None or device is not None:
        t = t.to(device=device or t.device, dtype=dtype or t.dtype)
    return t


def _index32(t):
    return t.to(torch.int32)


def _rsp_components(dense):
    """The row_sparse components of a dense array: its rows with a nonzero
    entry, in order."""
    idx = torch.nonzero(
        (dense != 0).reshape(dense.shape[0], -1).any(dim=1)).reshape(-1)
    return {"data": dense.index_select(0, idx), "indices": _index32(idx)}


def _csr_components(dense):
    """The csr components of a dense 2-D array, in row-major order."""
    rows, cols = torch.nonzero(dense, as_tuple=True)
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                         device=dense.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=dense.shape[0]),
                              0)
    return {"data": dense[rows, cols], "indices": _index32(cols),
            "indptr": _index32(indptr)}


class BaseSparseNDArray(NDArray):
    """Compound-storage NDArray. ``_data`` (the dense view) is computed on
    first read; the sparse components live in ``_aux``, a dict of
    tensors."""

    __slots__ = ("_aux", "_shape_meta", "_dtype_meta", "_dense_cache",
                 "_aux_stale", "_ctx", "_stype")

    def __init__(self, aux, shape, dtype, ctx, stype):
        self._aux = aux
        self._shape_meta = tuple(int(s) for s in shape)
        self._dtype_meta = torch_dtype(dtype)
        self._dense_cache = None
        self._aux_stale = False
        self._ctx = ctx if ctx is not None else context_of(
            next(iter(aux.values())).device)
        self._stype = stype
        self.grad = None
        self.grad_req = "null"
        self._ag_marked = False
        self._fresh_grad = False

    # -- the lazy dense view --------------------------------------------------

    @property
    def _data(self):
        if self._dense_cache is None:
            self._dense_cache = self._to_dense()
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        # a dense value was written (the fallback path): the components
        # re-sparsify from it at their next read
        self._dense_cache = value
        self._shape_meta = tuple(int(s) for s in value.shape)
        self._dtype_meta = value.dtype
        self._aux_stale = True

    def _components(self):
        if self._aux_stale:
            self._aux = self._resparsify(self._dense_cache)
            self._aux_stale = False
        return self._aux

    def _set_components(self, **aux):
        """Replace the components; the dense view is dropped."""
        self._aux = aux
        self._dense_cache = None
        self._aux_stale = False

    def densified(self):
        """True once the dense view has been built."""
        return self._dense_cache is not None

    @property
    def device(self):
        return next(iter(self._components().values())).device

    @property
    def shape(self):
        return self._shape_meta

    @property
    def dtype(self):
        return np_dtype(self._dtype_meta)

    @property
    def ndim(self):
        return len(self._shape_meta)

    @property
    def size(self):
        return int(_np.prod(self._shape_meta)) if self._shape_meta else 0

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def stype(self):
        return self._stype

    def wait_to_read(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    wait_to_write = wait_to_read

    def _nd(self, name):
        return NDArray(self._components()[name])

    def tostype(self, stype):
        return cast_storage(self, stype)

    def __repr__(self):
        shape = "x".join(map(str, self.shape))
        return f"\n<{type(self).__name__} {shape} @{self._ctx}>"

    __str__ = __repr__

    def _to_dense(self):
        raise NotImplementedError

    def _resparsify(self, dense):
        raise NotImplementedError


class RowSparseNDArray(BaseSparseNDArray):
    """row_sparse: (data [K, ...], indices [K]), the K occupied rows of a
    logically dense (N, ...) array. Indices are sorted and unique."""

    def __init__(self, data, indices, shape, ctx=None):
        data = _tensor(data)
        indices = _index32(_tensor(indices, device=data.device))
        super().__init__({"data": data, "indices": indices}, shape,
                         data.dtype, ctx, "row_sparse")

    @property
    def data(self):
        return self._nd("data")

    @property
    def indices(self):
        return self._nd("indices")

    def _to_dense(self):
        aux = self._components()
        dense = torch.zeros(self._shape_meta, dtype=self._dtype_meta,
                            device=aux["data"].device)
        if aux["indices"].numel():
            dense[aux["indices"].long()] = aux["data"].to(self._dtype_meta)
        return dense

    def _resparsify(self, dense):
        return _rsp_components(dense)

    def __setitem__(self, key, value):
        # ``g[:] = 0`` (Parameter.zero_grad) stays O(rows): the components
        # are emptied, no dense zeros(table) is made
        if isinstance(key, slice) and key == slice(None) and \
                _np.isscalar(value) and value == 0:
            data = self._components()["data"]
            self._set_components(
                data=data.new_zeros((0,) + self._shape_meta[1:]),
                indices=torch.zeros(0, dtype=torch.int32,
                                    device=data.device))
            return
        super().__setitem__(key, value)

    def astype(self, dtype, copy=True):
        """Stays row_sparse: the reference's Cast keeps the storage type."""
        aux = self._components()
        return RowSparseNDArray(aux["data"].to(torch_dtype(dtype)),
                                aux["indices"].clone(), self.shape,
                                self._ctx)

    def copy(self):
        aux = self._components()
        return RowSparseNDArray(aux["data"].clone(), aux["indices"].clone(),
                                self.shape, self._ctx)

    def retain(self, indices):
        return retain(self, indices)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return add(self, other)
        return super().__add__(other)


class CSRNDArray(BaseSparseNDArray):
    """csr: (data [nnz], indices [nnz], indptr [N + 1]), a 2-D sparse
    matrix."""

    def __init__(self, data, indices, indptr, shape, ctx=None):
        data = _tensor(data)
        super().__init__(
            {"data": data,
             "indices": _index32(_tensor(indices, device=data.device)),
             "indptr": _index32(_tensor(indptr, device=data.device))},
            shape, data.dtype, ctx, "csr")

    @property
    def data(self):
        return self._nd("data")

    @property
    def indices(self):
        return self._nd("indices")

    @property
    def indptr(self):
        return self._nd("indptr")

    def _row_ids(self):
        """Each stored value's row, from indptr (one searchsorted)."""
        aux = self._components()
        nnz = aux["data"].shape[0]
        pos = torch.arange(nnz, dtype=aux["indptr"].dtype,
                           device=aux["indptr"].device)
        return torch.searchsorted(aux["indptr"], pos, right=True) - 1

    def _to_dense(self):
        aux = self._components()
        dense = torch.zeros(self._shape_meta, dtype=self._dtype_meta,
                            device=aux["data"].device)
        if aux["data"].numel():
            dense[self._row_ids().long(), aux["indices"].long()] = \
                aux["data"].to(self._dtype_meta)
        return dense

    def _resparsify(self, dense):
        return _csr_components(dense)



def _device_of(ctx):
    from .ndarray import _device

    return _device(ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` and ``shape``, or from a
    dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 2 and \
            not isinstance(arg1[0], int):
        data, indices = arg1
        data = _dense_array(data, ctx=ctx, dtype=dtype)
        return RowSparseNDArray(
            data, _dense_array(indices, ctx=ctx, dtype="int32"), shape,
            ctx or data.context)
    dense = arg1 if isinstance(arg1, NDArray) else \
        _dense_array(arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` and ``shape``, or from
    a dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _dense_array(data, ctx=ctx, dtype=dtype)
        return CSRNDArray(data, _dense_array(indices, ctx=ctx, dtype="int32"),
                          _dense_array(indptr, ctx=ctx, dtype="int32"), shape,
                          ctx or data.context)
    dense = arg1 if isinstance(arg1, NDArray) else \
        _dense_array(arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "csr")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype``: no stored row or
    value."""
    dt = torch_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if stype == "row_sparse":
        dev = _device_of(ctx)
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev), shape, ctx)
    if stype == "csr":
        dev = _device_of(ctx)
        return CSRNDArray(torch.zeros(0, dtype=dt, device=dev),
                          torch.zeros(0, dtype=torch.int32, device=dev),
                          torch.zeros(shape[0] + 1, dtype=torch.int32,
                                      device=dev), shape, ctx)
    if stype in (None, "default"):
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    raise MXNetError(f"unknown stype {stype}")


def array(source_array, ctx=None, dtype=None):
    if isinstance(source_array, BaseSparseNDArray):
        return source_array
    return _dense_array(source_array, ctx=ctx, dtype=dtype)


def cast_storage(arr, stype):
    """The `cast_storage` op (`cast_storage-inl.h`), vectorized."""
    if isinstance(arr, BaseSparseNDArray) and arr.stype == stype:
        return arr
    if stype == "default":
        return NDArray(arr._data)
    ctx = arr.context
    if isinstance(arr, BaseSparseNDArray):
        if stype not in ("row_sparse", "csr"):
            raise MXNetError(f"unknown stype {stype}")
        raise MXNetError(
            f"cast_storage from {arr.stype} to {stype} not supported")
    dense = arr._data.detach()
    if stype == "row_sparse":
        aux = _rsp_components(dense)
        return RowSparseNDArray(aux["data"], aux["indices"], dense.shape,
                                ctx)
    if stype == "csr":
        if dense.dim() != 2:
            raise MXNetError("cast_storage to csr needs a 2-D array")
        aux = _csr_components(dense)
        return CSRNDArray(aux["data"], aux["indices"], aux["indptr"],
                          dense.shape, ctx)
    raise MXNetError(f"unknown stype {stype}")


def retain(arr, indices):
    """sparse_retain (`sparse_retain.cc`): only the requested rows stay;
    index math on the components, never a dense view."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    aux = arr._components()
    idx = _tensor(indices, device=aux["indices"].device).reshape(-1)
    kept = torch.nonzero(torch.isin(aux["indices"], _index32(idx)))
    kept = kept.reshape(-1)
    return RowSparseNDArray(aux["data"].index_select(0, kept),
                            aux["indices"].index_select(0, kept), arr.shape,
                            arr.context)


def add(lhs, rhs):
    """row_sparse + row_sparse -> row_sparse through the union of the
    indices; never a dense view."""
    if not (isinstance(lhs, RowSparseNDArray)
            and isinstance(rhs, RowSparseNDArray)):
        raise MXNetError("add expects two RowSparseNDArrays")
    if lhs.shape != rhs.shape:
        raise MXNetError(f"add: shapes {lhs.shape} and {rhs.shape} differ")
    la, ra = lhs._components(), rhs._components()
    union = torch.unique(torch.cat([la["indices"], ra["indices"]]))
    out = la["data"].new_zeros((union.shape[0],) + lhs.shape[1:])
    out.index_add_(0, torch.searchsorted(union, la["indices"]), la["data"])
    out.index_add_(0, torch.searchsorted(union, ra["indices"]),
                   ra["data"].to(out.dtype))
    return RowSparseNDArray(out, union, lhs.shape, lhs.context)


def square_sum(arr, axis=None, keepdims=False):
    """_square_sum over row_sparse (`square_sum.cc`), on the stored rows
    only."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("square_sum expects a RowSparseNDArray")
    aux = arr._components()
    sq = aux["data"] * aux["data"]
    if axis is None:
        total = sq.sum()
        return NDArray(total.reshape((1,) * arr.ndim if keepdims else ()))
    if axis in (1, -1) and arr.ndim == 2:
        out = sq.new_zeros(arr.shape[0])
        out[aux["indices"].long()] = sq.sum(dim=1)
        return NDArray(out[:, None] if keepdims else out)
    raise MXNetError(f"square_sum: unsupported axis {axis}")


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse dot (`dot.cc`): csr x dense and csr^T x dense as one
    multiply and one segment sum (``index_add_``) over the stored values;
    other operands through the dense `dot` op."""
    if isinstance(lhs, CSRNDArray) and not isinstance(rhs, BaseSparseNDArray) \
            and not transpose_b and rhs.ndim == 2:
        aux = lhs._components()
        data = aux["data"]
        cols = aux["indices"]
        rows = lhs._row_ids()
        r = rhs._data.detach()
        if transpose_a:
            gather, scatter, n = rows, cols, lhs.shape[1]
        else:
            gather, scatter, n = cols, rows, lhs.shape[0]
        contrib = data[:, None].to(r.dtype) * r.index_select(0, gather)
        out = r.new_zeros((n, r.shape[1]))
        out.index_add_(0, scatter, contrib)
        return NDArray(out)
    from .register import invoke_nd

    return invoke_nd("dot", NDArray(lhs._data), NDArray(rhs._data),
                     transpose_a=transpose_a, transpose_b=transpose_b)


def unique_rows(row_ids, device):
    """The sorted unique row ids of an NDArray, tensor or array-like, as
    int64 on ``device``."""
    t = getattr(row_ids, "_data", row_ids)
    return torch.unique(torch.as_tensor(t).reshape(-1).to(device).long())


def fill_rows(target, val, ridx):
    """Write the rows ``ridx`` of the dense tensor ``val`` into ``target``
    (`row_sparse_pull`'s contract): a row_sparse target gets them as its
    components, a dense one (NDArray or tensor) the full shape with them
    filled and every other row zero."""
    rows = val.index_select(0, ridx)
    if isinstance(target, RowSparseNDArray):
        target._set_components(data=rows.to(target._dtype_meta),
                               indices=ridx.to(torch.int32))
        return
    result = torch.zeros_like(val)
    result.index_copy_(0, ridx, rows)
    if isinstance(target, torch.Tensor):
        target.copy_(result)
    else:
        target._rebind(result)
