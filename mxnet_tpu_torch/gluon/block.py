"""gluon.Block and HybridBlock, the neural-network containers: the port of
`mxnet_tpu/gluon/block.py` (parity `python/mxnet/gluon/block.py`).

`hybridize` makes the outermost active HybridBlock run through one
`CachedOp` whose inputs are its parameters (as state) and its data: on a
CUDA card the forward, and under `record()` the backward, are CUDA graphs
captured at the first call of each input signature and replayed after
(`mxnet_tpu_torch._cached_op`); on the CPU the same code runs eagerly.
Nested hybridized children run inside the outer block's function, their
parameters taken from it (``_PARAM_OVERRIDE``), as in the JAX package.
``hybrid_forward`` gets ``F = mxnet_tpu_torch.ndarray`` in both modes.

Deferred shape inference runs the forward on ``meta`` tensors, which
compute shapes and no values (the JAX package uses `jax.eval_shape`): each
layer with a parameter of unknown shape sets it from its input's shape
(its `infer_shape`), then the parameters are allocated.

Not ported: `SymbolBlock` and `export`, which need the symbolic API
(ROADMAP.md queue A, item 5); both raise NotImplementedError.
"""
from __future__ import annotations

import contextvars
import re
import threading
import warnings

import numpy as _np
import torch

from .. import autograd
from .. import name as _name
from .. import ndarray as nd
from .._cached_op import CachedOp
from ..base import MXNetError, torch_dtype
from ..context import cpu
from ..ndarray import NDArray
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _shape_complete)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

# While a hybridized block's function runs, Parameter values come from this
# map, id(Parameter) -> NDArray; an empty map runs nested blocks eagerly
_PARAM_OVERRIDE = contextvars.ContextVar("mxnet_tpu_torch_param_override",
                                         default=None)
# True while the shape-only pass on meta tensors runs: parameters must not
# be allocated inside it
_SHAPE_INFER = contextvars.ContextVar("mxnet_tpu_torch_shape_infer",
                                      default=False)


class _BlockScope:
    """The name scope of a Block (parity block.py:35)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        self._name_scope = _name.Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def _flatten(args, inout_str):
    """A nested list of NDArrays as a flat list and its format."""
    if isinstance(args, NDArray):
        return [args], 0
    if args is None:
        return [None], -1
    if not isinstance(args, (list, tuple)):
        raise TypeError(f"{inout_str} must be (nested) list of NDArray, but "
                        f"got {type(args)}")
    flat, fmts = [], []
    for i in args:
        arg, fmt = _flatten(i, inout_str)
        flat.extend(arg)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    if isinstance(fmt, int):
        if fmt == -1:
            return None, args
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


class Block:
    """The base of every layer and model (parity `gluon/block.py:127`)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = {}
        self._forward_pre_hooks = {}

    def __repr__(self):
        modstr = "\n".join(f"  ({key}): {_indent(repr(block), 2)}"
                           for key, block in self.__dict__.items()
                           if isinstance(block, Block))
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError(f"Changing attribute type for {self.name} "
                                f"from {type(existing)} to {type(value)} is "
                                "not allowed.")
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if name in self._reg_params and self._reg_params[name] is not value:
                raise AssertionError(
                    f"Overriding Parameter attribute {name} is not allowed. "
                    "If you want to share parameters between blocks, please "
                    "set 'params' at Block construction instead.")
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        """This block's own ParameterDict (no children's)."""
        return self._params

    def collect_params(self, select=None):
        """A ParameterDict of this block's and its children's Parameters,
        those whose names match the regex ``select`` if given; a Parameter
        shared by several blocks appears once. A Parameter held as a plain
        attribute is keyed ``"<block name>.<attribute>"``."""
        self._check_container_with_block()
        ret = ParameterDict(self._params.prefix)
        seen = set()

        def merge(items):
            fresh = {}
            for name, p in items:
                if id(p) not in seen:
                    seen.add(id(p))
                    fresh[name] = p
            ret.update(fresh)

        lib_params = set(map(id, self.params.values()))
        direct = {f"{self.name}.{attr}": p
                  for attr, p in self._reg_params.items()
                  if id(p) not in lib_params}
        pattern = re.compile(select) if select else None
        for items in (self.params.items(), direct.items()):
            merge((n, v) for n, v in items
                  if pattern is None or pattern.match(n))
        for cld in self._children.values():
            merge(cld.collect_params(select=select).items())
        return ret

    def _check_container_with_block(self):
        children = set(self._children.values())
        for k, v in self.__dict__.items():
            if isinstance(v, (list, tuple, dict)) and not k.startswith("_"):
                items = v.values() if isinstance(v, dict) else v
                for item in items:
                    if isinstance(item, Block) and item not in children:
                        warnings.warn(
                            f'"{item}" is an unregistered container with '
                            "Blocks. Note that Blocks inside the list, tuple "
                            "or dict will not be registered automatically. "
                            "Make sure to register them using "
                            "register_child() or switching to "
                            "nn.Sequential/nn.HybridSequential instead.")

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_pre_hook(self, hook):
        handle = _HookHandle(self._forward_pre_hooks)
        self._forward_pre_hooks[handle.id] = hook
        return handle

    def register_forward_hook(self, hook):
        handle = _HookHandle(self._forward_hooks)
        self._forward_hooks[handle.id] = hook
        return handle

    def apply(self, fn):
        """Apply ``fn`` to every child, recursively, then to this block."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter of the block and its children."""
        from .. import initializer
        if init is None:
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters keyed by their structural names (the
        attribute path, ``features.0.weight``) in `nd.save`'s format."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {key: val.data(val.list_ctx()[0]).copyto(cpu())
                           for key, val in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load parameters saved by `save_parameters` (of either package),
        or, from a file of full names, through `ParameterDict.load`."""
        loaded = nd.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in i for i in loaded.keys()):
            del loaded
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra, self.prefix)
            return
        if not allow_missing:
            for name in params.keys():
                if name not in loaded:
                    raise ValueError(
                        f"Parameter '{name}' is missing in file '{filename}',"
                        " which contains parameters: "
                        f"{_brief_print_list(loaded.keys())}. Set "
                        "allow_missing=True to ignore missing parameters.")
        for name in loaded:
            if not ignore_extra and name not in params:
                raise ValueError(
                    f"Parameter '{name}' loaded from file '{filename}' is not "
                    "present in ParameterDict, which contains parameters "
                    f"{_brief_print_list(params.keys())}. Set "
                    "ignore_extra=True to ignore.")
            if name in params:
                params[name]._load_init(loaded[name], ctx)

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    save_params = save_parameters
    load_params = load_parameters

    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        """Override to implement the forward computation with NDArrays."""
        raise NotImplementedError

    def summary(self, *inputs):
        """Print each layer's output shape and parameter count, from one
        forward pass on ``inputs``."""
        summary, hooks = [], []

        def _register(block):
            def hook(blk, inp, out):
                n_params = sum(int(_np.prod(p.shape))
                               for p in blk._reg_params.values()
                               if p.shape is not None)
                out0 = out[0] if isinstance(out, (list, tuple)) else out
                summary.append((blk.name, type(blk).__name__,
                                getattr(out0, "shape", None), n_params))
            hooks.append(block.register_forward_hook(hook))

        self.apply(_register)
        try:
            self(*inputs)
            print(f"{'Layer (type)':<44}{'Output Shape':<24}{'Param #':<12}")
            print("=" * 80)
            total = 0
            for name, cls, shape, n in summary:
                print(f"{name + ' (' + cls + ')':<44}{str(shape):<24}"
                      f"{n:<12}")
                total += n
            print("=" * 80)
            print(f"Total params: {total}")
        finally:
            for h in hooks:
                h.detach()


class _HookHandle:
    _next_id = [0]

    def __init__(self, hooks_dict):
        self._hooks_dict = hooks_dict
        self.id = _HookHandle._next_id[0]
        _HookHandle._next_id[0] += 1

    def detach(self):
        self._hooks_dict.pop(self.id, None)


def _indent(s_, num_spaces):
    lines = s_.split("\n")
    if len(lines) == 1:
        return s_
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line for line in lines)


def _brief_print_list(lst, limit=7):
    lst = list(lst)
    if len(lst) > limit:
        return ", ".join(map(repr, lst[:limit // 2])) + ", ..., " + \
            ", ".join(map(repr, lst[-limit // 2:]))
    return ", ".join(map(repr, lst))


def _param_value(p):
    """A parameter's value: the override while a hybridized function runs,
    a ``meta`` stand-in in the shape pass, else its data."""
    overrides = _PARAM_OVERRIDE.get()
    if overrides is not None and id(p) in overrides:
        return overrides[id(p)]
    if _SHAPE_INFER.get() and _shape_complete(p.shape):
        return NDArray(torch.empty(p.shape, dtype=torch_dtype(p.dtype),
                                   device="meta"))
    return p.data()


class HybridBlock(Block):
    """A Block whose forward can run as one captured program (parity
    `gluon/block.py:671`). ``hybrid_forward(self, F, x, *args, **params)``
    gets ``F = mxnet_tpu_torch.ndarray``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._cached_op = None
        self._active = False
        self._flags = {}
        self._in_fmt = None

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, (HybridBlock, Parameter)):
            self._clear_cached_op()

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                f"Children of HybridBlock must also be HybridBlock, but "
                f"{block} has type {type(block)}. If you are using "
                "Sequential, please try HybridSequential instead.")
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, static_alloc=False, static_shape=False):
        self._active = active
        self._flags = {"static_alloc": static_alloc,
                       "static_shape": static_shape}
        self._clear_cached_op()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_op = None

    # -- deferred shape inference --------------------------------------------

    def infer_shape(self, *args):
        """Set the shapes of deferred parameters from the inputs' shapes.
        Layers override it; the generic version runs the forward on meta
        tensors, where each layer sets its own."""
        self._generic_infer_shape(*args)

    def infer_type(self, *args):
        self._generic_infer_shape(*args)

    def _generic_infer_shape(self, *args):
        if getattr(self, "_in_shape_inference", False):
            raise NotImplementedError(
                f"{type(self).__name__} has uninitialized parameters with "
                "unknown shape and does not override `infer_shape`. "
                "Construct it with fully-specified shapes "
                "(in_units/in_channels) or implement `infer_shape`.")
        self._in_shape_inference = True
        try:
            flat, fmt = _flatten(args, "input")
            metas = [NDArray(torch.empty(a.shape, dtype=a._data.dtype,
                                         device="meta"))
                     if isinstance(a, NDArray) else a for a in flat]
            re_args, _ = _regroup(metas, fmt)
            if not isinstance(re_args, (list, tuple)):
                re_args = [re_args]
            token = _PARAM_OVERRIDE.set({})
            token2 = _SHAPE_INFER.set(True)
            try:
                with autograd.pause(train_mode=autograd.is_training()):
                    self.forward(*re_args)
            finally:
                _SHAPE_INFER.reset(token2)
                _PARAM_OVERRIDE.reset(token)
            for p in self.collect_params().values():
                if p._deferred_init:
                    p._finish_deferred_init()
        finally:
            self._in_shape_inference = False

    def _deferred_infer_shape(self, *args):
        try:
            self.infer_shape(*args)
        except Exception as e:
            raise ValueError("Deferred initialization failed because shape "
                             f"cannot be inferred. {e}") from e

    # -- forward --------------------------------------------------------------

    def _build_cache(self):
        """The CachedOp: the parameters as leading (state) inputs, then the
        data."""
        params = self._cached_graph_params = \
            list(self.collect_params().values())

        def fn(*arrays):
            n = len(params)
            token = _PARAM_OVERRIDE.set(
                {id(p): a for p, a in zip(params, arrays[:n])})
            try:
                args, _ = _regroup(list(arrays[n:]), self._in_fmt)
                if not isinstance(args, (list, tuple)):
                    args = [args]
                out = self.forward(*args)
            finally:
                _PARAM_OVERRIDE.reset(token)
            flat, self._out_fmt = _flatten(out, "output")
            return flat

        self._cached_op = CachedOp(fn, n_state=len(params), **self._flags)

    def _call_cached_op(self, *args):
        flat_args, fmt = _flatten(args, "input")
        if self._cached_op is None or fmt != self._in_fmt:
            self._in_fmt = fmt
            self._build_cache()
        params = self._cached_graph_params
        try:
            param_nds = [p.data() for p in params]
        except DeferredInitializationError:
            self._deferred_infer_shape(*args)
            for p in params:
                if p._deferred_init:
                    p._finish_deferred_init()
            param_nds = [p.data() for p in params]
        out = self._cached_op(*(param_nds + list(flat_args)))
        if isinstance(out, NDArray):
            out = [out]
        ret, _ = _regroup(list(out), self._out_fmt)
        return ret

    def forward(self, x, *args):
        """Run ``hybrid_forward`` with ``F = nd`` and the parameters'
        values; through the CachedOp when this block is the outermost
        hybridized one. Given a Symbol, ``F = mx.sym`` and the parameters'
        variables: the trace that `export` writes."""
        from ..symbol import Symbol

        if isinstance(x, Symbol):
            from .. import symbol as _sym_api

            params = {k: v.var() for k, v in self._reg_params.items()}
            return self.hybrid_forward(_sym_api, x, *args, **params)
        if self._active and _PARAM_OVERRIDE.get() is None:
            return self._call_cached_op(x, *args)
        try:
            params = {k: _param_value(v) for k, v in self._reg_params.items()}
        except DeferredInitializationError:
            self._deferred_infer_shape(x, *args)
            if not _SHAPE_INFER.get():
                for p in self._reg_params.values():
                    if p._deferred_init:
                        p._finish_deferred_init()
            params = {k: _param_value(v) for k, v in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Override to implement the forward computation with ``F``'s ops."""
        raise NotImplementedError

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``path-symbol.json`` and ``path-####.params`` (reference
        block.py HybridBlock.export): the forward traced with
        ``F = mx.sym``, so the files load in `SymbolBlock.imports` and the
        Module's checkpoint loader, of either package. Returns the
        symbol."""
        from .. import symbol as _sym_api

        n_in = len(self._in_fmt) if isinstance(self._in_fmt, (list, tuple)) \
            else 1
        if n_in == 1:
            data_syms = [_sym_api.var("data")]
        else:
            data_syms = [_sym_api.var(f"data{i}") for i in range(n_in)]
        out = self(*data_syms)
        if not isinstance(out, (list, tuple)):
            out = [out]
        sym = _sym_api.Group(list(out)) if len(out) > 1 else out[0]
        sym.save(f"{path}-symbol.json", remove_amp_cast=remove_amp_cast)

        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        arg_dict = {}
        for name, param in self.collect_params().items():
            if name in arg_names:
                arg_dict[f"arg:{name}"] = param.data().as_in_context(cpu())
            elif name in aux_names:
                arg_dict[f"aux:{name}"] = param.data().as_in_context(cpu())
        nd.save(f"{path}-{epoch:04d}.params", arg_dict)
        return sym


class SymbolBlock(HybridBlock):
    """A block over a Symbol graph (reference `block.py:952`): what
    `HybridBlock.export` and `model.save_checkpoint` files load into. Its
    parameters are the symbol's arguments other than the inputs, named as
    in the symbol; the graph runs through the executor's graph function
    (`symbol/executor.py` `_graph_fn`)."""

    def __init__(self, outputs, inputs, params=None):
        from ..symbol.symbol import Group, Symbol

        # param names must equal the symbol's argument names: no prefix
        super().__init__(prefix="", params=None)
        self._params = ParameterDict("", shared=params)

        if isinstance(inputs, Symbol):
            inputs = list(inputs) if len(inputs) > 1 else [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs)) if len(outputs) > 1 \
                else outputs[0]
        self._sym = outputs
        self._input_names = [i.name for i in inputs]

        arg_names = self._sym.list_arguments()
        aux_names = set(self._sym.list_auxiliary_states())
        self._param_order = []
        for name in arg_names + sorted(aux_names):
            if name in self._input_names:
                continue
            grad_req = "null" if name in aux_names else "write"
            self._reg_params[name] = self.params.get(
                name, grad_req=grad_req, allow_deferred_init=True)
            self._param_order.append(name)
        self._graph_fns = {}

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None,
                allow_missing=False, ignore_extra=False):
        """Load an exported model: ``SymbolBlock.imports('m-symbol.json',
        ['data'], 'm-0000.params')`` (reference block.py
        SymbolBlock.imports)."""
        from .. import symbol as _sym_api

        sym = _sym_api.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [_sym_api.var(n) for n in input_names])
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx,
                                      allow_missing=allow_missing,
                                      ignore_extra=ignore_extra)
        return ret

    def _sb_fn(self, train):
        fn = self._graph_fns.get(train)
        if fn is None:
            from ..symbol.executor import _graph_fn

            aux = self._sym.list_auxiliary_states()
            args = self._input_names + [p for p in self._param_order
                                        if p not in aux]
            fn = self._graph_fns[train] = _graph_fn(self._sym, args, aux,
                                                    train)
        return fn

    def _finish_shapes(self, inputs):
        """Deferred parameters get their shapes from the inputs'."""
        shapes = {n: tuple(i.shape) for n, i in zip(self._input_names,
                                                    inputs)}
        arg_shapes, _, aux_shapes = self._sym.infer_shape_partial(**shapes)
        named = list(zip(self._sym.list_arguments(), arg_shapes)) + \
            list(zip(self._sym.list_auxiliary_states(), aux_shapes))
        for n, s in named:
            p = self._reg_params.get(n)
            if p is not None and s is not None and p._data is None:
                p.shape = s
                if p._deferred_init:
                    p._finish_deferred_init()
                else:
                    p.initialize()

    def forward(self, x, *args):
        from ..symbol import Symbol

        if isinstance(x, Symbol):
            raise MXNetError("SymbolBlock cannot be re-traced symbolically")
        if self._active and _PARAM_OVERRIDE.get() is None:
            return self._call_cached_op(x, *args)
        inputs = [x] + [a for a in args if a is not None]
        if len(inputs) != len(self._input_names):
            raise MXNetError(f"SymbolBlock expects {len(self._input_names)} "
                             f"inputs {self._input_names}, got {len(inputs)}")
        try:
            values = {n: _param_value(self._reg_params[n])
                      for n in self._param_order}
        except DeferredInitializationError:
            self._finish_shapes(inputs)
            values = {n: _param_value(self._reg_params[n])
                      for n in self._param_order}
        aux_names = self._sym.list_auxiliary_states()
        train = bool(autograd.is_training())
        recording = autograd.is_recording()
        arg_nds = inputs + [values[n] for n in self._param_order
                            if n not in aux_names]
        if recording:
            for a in arg_nds:
                autograd._note_input(a)
        aux_nds = [values[n] for n in aux_names]
        with torch.set_grad_enabled(recording):
            outs, aux_new = self._sb_fn(train)(
                tuple(a._data for a in arg_nds),
                tuple(a._data for a in aux_nds))
        if train:
            with torch.no_grad():
                for a, new in zip(aux_nds, aux_new):
                    if new is not a._data:
                        a._data.copy_(new)
        out_nds = [NDArray(o) for o in outs]
        return out_nds[0] if len(out_nds) == 1 else out_nds
