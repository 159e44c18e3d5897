"""Operator registry: the port of `mxnet_tpu/ops/registry.py`.

Every op is a plain function on tensors, ``fn(*tensors, **attrs) -> tensor
| tuple``, written with torch operations so that torch's autograd
differentiates it. Ops run eagerly: the JAX package's per-op XLA jit cache
has no counterpart here. Shape and dtype inference runs the same function
on ``meta`` tensors (`infer`), which compute no values.
"""
from __future__ import annotations

import inspect

import torch

from ..base import MXNetError

__all__ = ["Op", "register", "alias", "get_op", "list_ops", "attr_schema",
           "validate_attrs", "invoke", "infer"]

_OPS: dict[str, "Op"] = {}


class Op:
    """A registered operator."""

    __slots__ = ("name", "fn", "num_outputs", "mutate_aux", "wrap_kwargs",
                 "doc", "needs_rng", "needs_mode", "tensor_opts",
                 "sparse_vjp", "_schema_cache")

    def __init__(self, name, fn, num_outputs=1, mutate_aux=None,
                 wrap_kwargs=None, needs_rng=False, needs_mode=False,
                 tensor_opts=(), sparse_vjp=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs  # int or callable(attrs) -> int
        # RNG-consuming ops (Dropout): fn takes a `torch.Generator` on the
        # inputs' device as its FIRST argument; the frontend draws it from
        # `mxnet_tpu_torch.random`
        self.needs_rng = needs_rng
        # train/predict-polymorphic ops (Dropout, BatchNorm): the frontend
        # passes `_train=autograd.is_training()`
        self.needs_mode = needs_mode
        # indices of *inputs* that receive the op's trailing outputs, written
        # in place by the frontend (BatchNorm moving stats, optimizer states):
        # a static tuple, or callable(attrs) -> tuple
        self.mutate_aux = mutate_aux
        self.wrap_kwargs = wrap_kwargs  # canonicalize attrs before the call
        # optional tensor inputs after the required ones (CTCLoss's
        # lengths), in the fn's positional order: a Symbol node records
        # which it was given (``__opt_in__``)
        self.tensor_opts = tuple(tensor_opts)
        # storage-aware backward (the reference's FInferStorageType role):
        # ``sparse_vjp(*tensors, **attrs)`` computes the op so that its
        # weight gradient is row-sparse (a torch sparse COO tensor), or
        # returns None to decline; the imperative frontend calls it under
        # recording, outside a hybridized block's function
        self.sparse_vjp = sparse_vjp
        self._schema_cache = None
        self.doc = fn.__doc__

    def n_out(self, attrs):
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def __repr__(self):
        return f"Op({self.name})"


def register(name, aliases=(), num_outputs=1, mutate_aux=None,
             wrap_kwargs=None, needs_rng=False, needs_mode=False,
             tensor_opts=(), sparse_vjp=None):
    """Decorator: register a torch fn as operator ``name`` (+ aliases)."""

    def deco(fn):
        op = Op(name, fn, num_outputs=num_outputs, mutate_aux=mutate_aux,
                wrap_kwargs=wrap_kwargs, needs_rng=needs_rng,
                needs_mode=needs_mode, tensor_opts=tensor_opts,
                sparse_vjp=sparse_vjp)
        _OPS[name] = op
        for a in aliases:
            _OPS[a] = op
        return fn

    return deco


def alias(name, target):
    _OPS[name] = _OPS[target]


def get_op(name):
    op = _OPS.get(name)
    if op is None:
        raise AttributeError(f"Operator '{name}' is not registered")
    return op


def list_ops():
    return sorted(_OPS)


# Keys meaningful to the dispatch/frontend layer rather than any op fn.
_FRAMEWORK_ATTRS = frozenset({"name", "attr", "out", "ctx", "_train",
                              "__opt_in__"})
# Reference performance hints that cannot change results: accepted, ignored.
_PERF_HINT_ATTRS = frozenset({"cudnn_off", "cudnn_tune", "workspace",
                              "cudnn_algo_verbose"})


def attr_schema(op):
    """The op's declared parameters, from its fn signature: {name: default}
    for every keyword parameter, or None when the fn is fully open
    (``*args``/``**kwargs`` only, e.g. add_n)."""
    cached = op._schema_cache
    if cached is not None:
        return cached or None
    sig = inspect.signature(op.fn)
    named = [p for p in sig.parameters.values()
             if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                           inspect.Parameter.KEYWORD_ONLY)]
    if op.needs_rng and named:
        named = named[1:]  # the generator is injected, never user-facing
    op._schema_cache = {p.name: p.default for p in named}
    return op._schema_cache or None


def validate_attrs(op, attrs):
    """Reject unknown keyword arguments, as the reference's dmlc::Parameter
    Init() does: a silently ignored typo must not train wrong."""
    schema = attr_schema(op)
    if schema is None:
        return
    unknown = [k for k in attrs
               if k not in schema and k not in _FRAMEWORK_ATTRS
               and k not in _PERF_HINT_ATTRS]
    if unknown:
        valid = ", ".join(n for n in schema if not n.startswith("_"))
        raise MXNetError(
            f"operator {op.name}: unknown argument(s) {sorted(unknown)}. "
            f"Valid parameters: [{valid}]")


def param_doc(op):
    """The schema as a docstring 'Parameters' section."""
    schema = attr_schema(op)
    if not schema:
        return ""
    lines = ["", "Parameters (keyword)", "--------------------"]
    for n, d in schema.items():
        if n.startswith("_"):
            continue
        if d is inspect.Parameter.empty:
            lines.append(f"{n} : required tensor input")
        else:
            lines.append(f"{n} : optional, default={d!r}")
    return "\n".join(lines)


def invoke(name, *tensors, **attrs):
    """Run op ``name`` on raw tensors, eagerly, under the caller's grad
    mode (NDArray-level dispatch lives in `ndarray.register`)."""
    op = get_op(name)
    if op.wrap_kwargs is not None:
        attrs = op.wrap_kwargs(attrs)
    return op.fn(*tensors, **attrs)


def infer(name, *specs, **attrs):
    """Output (shape, dtype) pairs of op ``name`` for inputs given as
    (shape, dtype) pairs (None for an absent optional input), from a run
    on ``meta`` tensors: the role of the JAX package's ``jax.eval_shape``.
    An op whose output shape depends on its input values cannot run there
    and raises."""
    from ..base import torch_dtype

    tensors = [None if spec is None else
               torch.empty(tuple(spec[0]), dtype=torch_dtype(spec[1]),
                           device="meta") for spec in specs]
    op = get_op(name)
    if op.needs_rng:
        tensors.insert(0, None)
    with torch.no_grad():
        outs = invoke(name, *tensors, **attrs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [(tuple(o.shape), o.dtype) for o in outs]
