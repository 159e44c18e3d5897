"""gluon.Parameter and ParameterDict: the port of
`mxnet_tpu/gluon/parameter.py` (parity `python/mxnet/gluon/parameter.py`).

A Parameter holds one NDArray per context and, unless ``grad_req`` is
``"null"``, a gradient NDArray beside it, marked for `autograd` (its tensor
is a leaf that requires grad). A shape entry of 0 is unknown: with
``allow_deferred_init`` the allocation waits for the first forward pass,
which infers it. `set_data` writes the new value into the parameter's
tensor in place, as the reference writes ``arr[:] = data``, so a captured
CUDA graph that reads the tensor sees it at its next replay.

With ``grad_stype="row_sparse"`` (Embedding's ``sparse_grad``) the
gradient buffer is a `RowSparseNDArray` with no row: backward deposits
(indices, rows) into it, `zero_grad` empties it and `cast` keeps it
sparse, so a large table's gradient never exists densely. The weight is
dense whatever ``stype`` says, as in the JAX package (gathers read it
where it lies); `row_sparse_data` gathers rows of it.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from .. import initializer
from .. import ndarray as nd
from ..base import MXNetError, dtype_name, np_dtype
from ..context import Context, cpu, current_context
from ..ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "tensor_types"]

tensor_types = (NDArray,)


class DeferredInitializationError(MXNetError):
    """A parameter whose initialization waits for its shape."""


def _shape_complete(shape):
    return shape is not None and all(int(s) > 0 for s in shape)


class Parameter:
    """A container of a Block's weight (parity `gluon/parameter.py`).
    ``grad_req`` is ``"write"``, ``"add"`` or ``"null"``; ``lr_mult`` and
    ``wd_mult`` scale the optimizer's learning rate and weight decay."""

    def __init__(self, name, grad_req="write", shape=None, dtype=_np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._data = None  # {(device type, id): NDArray}
        self._grad = None
        self._ctx_list = None
        self._deferred_init = ()
        self.name = name
        self._shape = tuple(int(s) for s in shape) \
            if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._stype = stype
        self._grad_stype = grad_stype
        self.grad_req = grad_req
        self.attributes = {}
        self._trainer = None
        self._var = None

    def _set_trainer(self, trainer):
        if self._trainer is not None and trainer is not None and \
                self._trainer is not trainer and self._stype != "default":
            raise RuntimeError(
                f"Failed to set the trainer for Parameter '{self.name}' "
                "because it was already set. More than one trainers for a "
                "sparse Parameter is not supported.")
        self._trainer = trainer

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)})")

    # -- properties ---------------------------------------------------------

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(
                f"grad_req must be one of write/add/null, got {req}")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if req == "null":
            self._grad = None
            for arr in (self._data or {}).values():
                arr.grad, arr.grad_req, arr._ag_marked = None, "null", False
                arr._data = arr._data.detach()
        elif self._data is not None:
            if self._grad is None:
                self._init_grad()
            else:
                for k, arr in self._data.items():
                    autograd.mark_variables(arr, self._grad[k], req)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(int(s) for s in new_shape) \
                if new_shape is not None else None
            return
        if len(self._shape) != len(new_shape) or not all(
                j in (0, i) for i, j in zip(new_shape, self._shape)):
            raise ValueError(f"Expected shape {new_shape} is incompatible "
                             f"with given shape {self._shape}")
        self._shape = tuple(int(s) for s in new_shape)

    @property
    def stype(self):
        return self._stype

    # -- initialization -----------------------------------------------------

    def initialize(self, init=None, ctx=None,
                   default_init=initializer.Uniform(), force_reinit=False):
        """Allocate the parameter (and its gradient) on each context and
        fill it: with ``init``, else the parameter's own ``init``, else by
        ``default_init``'s suffix rule. With an unknown shape and
        ``allow_deferred_init`` the allocation waits for the first forward
        pass."""
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None and self.init is not None:
            init = self.init
        if not _shape_complete(self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, None)
                return
            raise ValueError(f"Cannot initialize Parameter '{self.name}' "
                             f"because it has invalid shape: {self._shape}.")
        self._deferred_init = (init, ctx, default_init, None)
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        if not _shape_complete(self._shape):
            raise ValueError(
                f"Cannot initialize Parameter '{self.name}' because it has "
                f"invalid shape: {self._shape}. Please specify in_units, "
                "in_channels, etc for `Block`s.")
        with autograd.pause():
            if data is None:
                data = nd.zeros(self._shape, dtype=self.dtype, ctx=ctx[0])
                attrs = {}
                if init is not None:
                    init_obj = initializer.create(init)
                    # only registered classes survive the JSON round trip;
                    # a Constant's own initializer skips the suffix rule
                    if type(init_obj).__name__.lower() in \
                            initializer._INIT_REGISTRY:
                        attrs["__init__"] = init_obj.dumps()
                initializer.create(
                    init if init is not None else default_init)(
                        initializer.InitDesc(self.name, attrs), data)
            self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        if isinstance(ctx_list, Context):
            ctx_list = [ctx_list]
        self._ctx_list = list(ctx_list)
        self._data = {self._dev_key(c): data.copyto(c)
                      for c in self._ctx_list}
        self._grad = None
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = {}
        for k, arr in self._data.items():
            g = nd.zeros(arr.shape, dtype=arr._data.dtype, ctx=arr.context,
                         stype=self._grad_stype)
            self._grad[k] = g
            autograd.mark_variables(arr, g, self._grad_req)

    @staticmethod
    def _dev_key(ctx):
        return (ctx.device_type, ctx.device_id)

    def _check_and_get(self, arr_dict, ctx):
        if arr_dict is not None:
            if ctx is list:
                return list(arr_dict.values())
            if ctx is None:
                if len(arr_dict) == 1:
                    return next(iter(arr_dict.values()))
                ctx = current_context()
            if isinstance(ctx, list):
                return [self._check_and_get(arr_dict, c) for c in ctx]
            key = self._dev_key(ctx)
            if key in arr_dict:
                return arr_dict[key]
            raise RuntimeError(
                f"Parameter '{self.name}' was not initialized on context "
                f"{ctx}. It was only initialized on {self._ctx_list}.")
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Actual initialization "
                "happens during the first forward pass. Please pass one "
                "batch of data through the network before accessing "
                "Parameters.")
        raise RuntimeError(
            f"Parameter '{self.name}' has not been initialized. Note that "
            "you should initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params because the "
            "later does not include Parameters of nested child Blocks")

    # -- accessors ----------------------------------------------------------

    def data(self, ctx=None):
        return self._check_and_get(self._data, ctx)

    def list_data(self):
        self._check_and_get(self._data, list)
        return [self._data[self._dev_key(c)] for c in self._ctx_list]

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        return self._check_and_get(self._grad, ctx)

    def list_grad(self):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        self._check_and_get(self._grad, list)
        return [self._grad[self._dev_key(c)] for c in self._ctx_list]

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise RuntimeError(
                f"Parameter '{self.name}' has not been initialized")
        return self._ctx_list

    def set_data(self, data):
        """Set the value on every context: written in place into each
        context's tensor, cast to the parameter's dtype."""
        self.shape = data.shape
        if self._data is None:
            if not self._deferred_init:
                raise RuntimeError(
                    f"Parameter '{self.name}' has not been initialized")
            init, ctx, default_init, _ = self._deferred_init
            self._deferred_init = (
                init, ctx, default_init,
                data if isinstance(data, NDArray) else nd.array(
                    data, ctx=ctx[0]))
            return
        src = data._data if isinstance(data, NDArray) \
            else torch.as_tensor(_np.asarray(data))
        with torch.no_grad():
            for arr in self._data.values():
                arr._data.copy_(src)

    def zero_grad(self):
        """Set the gradient to zero, in place; a row-sparse one loses its
        rows."""
        if self._grad is None:
            return
        with torch.no_grad():
            for g in self._grad.values():
                if g.stype == "row_sparse":
                    g[:] = 0
                else:
                    g._data.zero_()

    def reset_ctx(self, ctx):
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is not None:
            self._init_impl(next(iter(self._data.values())), ctx)
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)
        else:
            raise ValueError(f"Cannot reset context for Parameter "
                             f"'{self.name}' because it has not been "
                             "initialized.")

    def cast(self, dtype):
        """Cast the data and gradient to ``dtype`` (new arrays)."""
        self.dtype = dtype
        if self._data is None:
            return
        with autograd.pause():
            for k in list(self._data):
                self._data[k] = self._data[k].astype(dtype)
            if self._grad is not None:
                for k in list(self._grad):
                    self._grad[k] = self._grad[k].astype(dtype)
                    autograd.mark_variables(self._data[k], self._grad[k],
                                            self._grad_req)

    def var(self):
        """The Symbol of this parameter (symbolic API)."""
        if self._var is None:
            from .. import symbol

            self._var = symbol.var(self.name, shape=self.shape,
                                   dtype=self.dtype, lr_mult=self.lr_mult,
                                   wd_mult=self.wd_mult, init=self.init)
        return self._var

    def _sparse_rows_from_store(self, row_id):
        """With a dist store that holds the weights (the optimizer on the
        store), refresh the rows first (`Trainer._row_sparse_pull`)."""
        if self._stype != "row_sparse" and self._grad_stype != "row_sparse":
            raise MXNetError(
                f"Parameter '{self.name}' is not sparse (stype="
                f"{self._stype}, grad_stype={self._grad_stype}); use data() "
                "instead")
        if not isinstance(row_id, NDArray):
            row_id = nd.array(row_id, dtype="int64")
        trainer = self._trainer
        if trainer is not None and getattr(trainer, "_kvstore", None) \
                is not None and "dist" in trainer._kvstore.type:
            trainer._row_sparse_pull(self, row_id)
        return row_id

    def row_sparse_data(self, row_id):
        """The rows ``row_id`` of this parameter, deduplicated and sorted,
        as a RowSparseNDArray (parity `gluon/parameter.py
        row_sparse_data`); the weight itself stays dense."""
        row_id = self._sparse_rows_from_store(row_id)
        return _gather_rows(self._check_and_get(self._data, None), row_id)

    def list_row_sparse_data(self, row_id):
        """`row_sparse_data` on every context, in `list_ctx` order."""
        row_id = self._sparse_rows_from_store(row_id)
        return [_gather_rows(a, row_id) for a in self.list_data()]

    def _load_init(self, data, ctx=None):
        """Initialize directly from a loaded array (shape checked, cast to
        the parameter's dtype), on ``ctx`` or else the current context (the
        JAX package's default context, `cpu()`)."""
        if self.shape is not None and any(self.shape):
            for self_dim, data_dim in zip(self.shape, data.shape):
                if self_dim not in (0, data_dim):
                    raise ValueError(
                        f"Failed loading Parameter '{self.name}' from saved "
                        f"params: shape incompatible expected {self.shape} "
                        f"vs saved {data.shape}")
            self.shape = tuple(i if i != 0 else j
                               for i, j in zip(self.shape, data.shape))
        if self.dtype is not None:
            data = data.astype(self.dtype, copy=False)
        if self._data is None:
            if self._deferred_init:
                ctx = self._deferred_init[1]
            elif ctx is None:
                ctx = [current_context()]
            self._init_impl(data, ctx)
        else:
            self.set_data(data)
        self._deferred_init = ()


def _gather_rows(arr, row_id):
    from ..ndarray import sparse

    t = arr._data.detach()
    uniq = sparse.unique_rows(row_id, t.device)
    return sparse.RowSparseNDArray(t.index_select(0, uniq), uniq, arr.shape,
                                   arr.context)


class Constant(Parameter):
    """A parameter that gradients never update (parity `gluon/parameter.py
    class Constant`)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd.array(value, ctx=cpu())
        self.value = value

        class Init(initializer.Initializer):
            def _init_weight(self, _, arr):
                self._set(arr, value._data)

            # a constant may have any name: no suffix rule applies
            _init_default = _init_bias = _init_gamma = _init_beta = \
                _init_weight

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=Init(),
                         differentiable=False)


class ParameterDict:
    """An ordered name -> Parameter map with a name prefix, optionally
    sharing another dict's parameters (parity gluon/parameter.py)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return f"{name}(\n" + "\n".join(f"  {v}" for v in self.values()) \
            + "\n)"

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._shared._params[name]
        return None

    def get(self, name, **kwargs):
        """The Parameter ``prefix + name``, made with ``kwargs`` if it does
        not exist; an existing one must agree with them."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape" and v is not None:
                param.shape = v
            elif not (v is None or v == existing or (
                    k == "dtype" and np_dtype(v) == np_dtype(existing))):
                raise AssertionError(
                    f"Cannot retrieve Parameter '{name}' because desired "
                    f"attribute does not match with stored for attribute "
                    f"'{k}': desired '{v}' vs stored '{existing}'")
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'. Please specify "
                               "value if you want to create a new constant.")
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None and not isinstance(param, Constant):
            raise AssertionError(
                f"Parameter '{name}' already exists but it is not a "
                "constant.")
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise ValueError(
                        "Cannot update self with other because they have "
                        f"different Parameters with the same name '{k}'")
            else:
                self._params[k] = v

    def initialize(self, init=initializer.Uniform(), ctx=None, verbose=False,
                   force_reinit=False):
        if verbose:
            init.set_verbosity(verbose=verbose)
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Save to an ``.params`` file (the reference's NDArray dict format,
        `nd.save`), keyed by full name."""
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    f"Prefix '{strip_prefix}' is to be stripped before "
                    f"saving, but Parameter's name '{param.name}' does not "
                    f"start with '{strip_prefix}'")
            arg_dict[param.name[len(strip_prefix):]] = \
                param.data(param.list_ctx()[0]).copyto(cpu())
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise ValueError(
                        f"restore_prefix is '{restore_prefix}' but Parameter "
                        f"name '{name}' does not start with it")
        lprefix = len(restore_prefix)
        loaded = nd.load(filename, ctx=cpu())
        arg_dict = {restore_prefix + (k[4:] if k.startswith(("arg:", "aux:"))
                                      else k): v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise ValueError(f"Parameter '{name[lprefix:]}' is "
                                     f"missing in file '{filename}'")
        for name in arg_dict:
            if name not in self._params:
                if not ignore_extra:
                    raise ValueError(
                        f"Parameter '{name[lprefix:]}' loaded from file "
                        f"'{filename}' is not present in ParameterDict")
                continue
            self[name]._load_init(arg_dict[name], ctx)

    def list_ctx(self):
        s = set()
        for v in self.values():
            s.update(v.list_ctx())
        return sorted(s, key=str)
