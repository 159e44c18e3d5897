"""NDArray-level op dispatch and the generated op namespaces: the port of
`mxnet_tpu/ndarray/register.py`.

``mx.nd.<op>(...)`` → `invoke_nd` → the registered torch fn on the inputs'
tensors, with grad enabled only under `autograd.record()`.
"""
from __future__ import annotations

import contextvars
import inspect
import sys
import time
import types

import numpy as _np
import torch

from .. import autograd
from .. import profiler as _prof
from .. import random as _random
from ..base import MXNetError
from ..context import Context
from ..ops import registry as _reg
from .ndarray import NDArray, _device

__all__ = ["invoke_nd", "populate_op_namespaces"]

_sig_cache = {}
# While a branch of `control_flow.cond` or the body of `while_loop` runs:
# a bool tensor, where the branch is taken or the loop active; every
# NDArray an op reads then passes the gradient gate of `ops.control_flow_ops`
_CF_KEEP = contextvars.ContextVar("mxnet_tpu_torch_cf_keep", default=None)


def _op_attr_params(op):
    """Names of the op fn's keyword (defaulted) params in declaration order,
    whether it takes ``*args`` tensors, and whether it takes ``device`` (a
    creation op, placed on the context it is asked for). Used to bind
    positional scalars the MXNet way (``nd.clip(x, 0, 1)``)."""
    cached = _sig_cache.get(id(op))
    if cached is None:
        params = inspect.signature(op.fn).parameters.values()
        attr_params = [p.name for p in params
                       if p.default is not inspect.Parameter.empty
                       and p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                      inspect.Parameter.KEYWORD_ONLY)
                       and p.name != "device"]
        varargs = any(p.kind == inspect.Parameter.VAR_POSITIONAL
                      for p in params)
        takes_device = any(p.name == "device" for p in params)
        cached = _sig_cache[id(op)] = (attr_params, varargs, takes_device)
    return cached


def _is_arr(a):
    return isinstance(a, (NDArray, _np.ndarray, torch.Tensor))


def invoke_nd(op_name, *args, out=None, name=None, **kwargs):
    """Run registered op ``op_name`` on NDArrays (parity
    `register.py:86-275`). ``out=`` rebinds the given array(s) to the
    result; ``mutate_aux`` outputs are copied in place into their input
    arrays, outside any graph.

    While the profiler runs, each call is recorded (`profiler.record_op`):
    its host dispatch time (cat "dispatch"), or with ``profile_all`` (or
    ``profile_sync``) set, its time to completion on the device, waited
    for (cat "operator"), as the JAX package labels them."""
    if _prof._running:
        t0 = time.perf_counter()
        res = _invoke_nd_impl(op_name, *args, out=out, name=name, **kwargs)
        sync = _prof._config.get("profile_all") or \
            _prof._config.get("profile_sync")
        if sync:
            first = res[0] if isinstance(res, (list, tuple)) else res
            if getattr(first, "_data", None) is not None and \
                    first._data.is_cuda:
                torch.cuda.synchronize(first._data.device)
        _prof.record_op(op_name, (time.perf_counter() - t0) * 1e6,
                        cat="operator" if sync else "dispatch")
        return res
    return _invoke_nd_impl(op_name, *args, out=out, name=name, **kwargs)


def _invoke_nd_impl(op_name, *args, out=None, name=None, **kwargs):
    op = _reg.get_op(op_name)
    ctx = kwargs.pop("ctx", None)
    if isinstance(ctx, str):
        devt, _, devid = ctx.replace(")", "").partition("(")
        ctx = Context(devt, int(devid or 0))
    kwargs = {k: v for k, v in kwargs.items() if v is not None or k == "axis"}
    recording = autograd.is_recording()

    attr_params, has_varargs, takes_device = _op_attr_params(op)
    device = next((a._data.device for a in args if isinstance(a, NDArray)),
                  None)
    if device is None:
        device = _device(ctx)
    nd_inputs = []  # aligned with `tensors`; None for non-NDArray slots
    tensors = []
    keep = _CF_KEEP.get()
    scalar_cursor = 0
    # a positional None keeps its slot when a LATER positional arg is an
    # array, so an absent optional input cannot shift the next one into its
    # place; trailing Nones are dropped
    last_arr = max((i for i, a in enumerate(args) if _is_arr(a)), default=-1)
    for i, a in enumerate(args):
        if isinstance(a, NDArray):
            if recording:
                autograd._note_input(a)
            tensors.append(a._data if keep is None or not recording
                           else _gate(keep, a._data))
            nd_inputs.append(a)
        elif a is None:
            if i < last_arr:
                tensors.append(None)
                nd_inputs.append(None)
        elif isinstance(a, (int, float, bool, str, tuple, list)) \
                and not has_varargs:
            # positional scalar/shape → the next free keyword attr
            while scalar_cursor < len(attr_params) \
                    and attr_params[scalar_cursor] in kwargs:
                scalar_cursor += 1
            if scalar_cursor < len(attr_params):
                kwargs[attr_params[scalar_cursor]] = a
                scalar_cursor += 1
            else:
                tensors.append(torch.as_tensor(a, device=device))
                nd_inputs.append(None)
        else:
            tensors.append(torch.as_tensor(a, device=device))
            nd_inputs.append(None)
    _reg.validate_attrs(op, kwargs)
    if op.needs_mode and "_train" not in kwargs:
        kwargs["_train"] = autograd.is_training()
    if op.needs_rng:
        tensors.insert(0, _random.generator(device))
    if takes_device:
        kwargs["device"] = device
    with torch.set_grad_enabled(recording):
        outs = None
        # a row-sparse gradient only outside control-flow bodies, whose
        # gradient gates take dense ones (the JAX package traces them)
        if recording and op.sparse_vjp is not None and keep is None and \
                autograd.sparse_grads_allowed():
            outs = op.sparse_vjp(*tensors, **kwargs)
        if outs is None:
            outs = _reg.invoke(op_name, *tensors, **kwargs)
    outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)

    n_user = len(outs)
    if op.mutate_aux:
        aux_idx = (op.mutate_aux(kwargs) if callable(op.mutate_aux)
                   else op.mutate_aux)
        n_user -= len(aux_idx)
        with torch.no_grad():
            for j, in_idx in enumerate(aux_idx):
                target = nd_inputs[in_idx]
                new = outs[n_user + j]
                if target is not None and new is not target._data:
                    target._data.copy_(new)
    out_nds = [NDArray(t) for t in outs[:n_user]]

    if out is not None:
        outs_list = out if isinstance(out, (list, tuple)) else [out]
        for tgt, src in zip(outs_list, out_nds):
            tgt._rebind(src._data)
        return out if not isinstance(out, (list, tuple)) else list(outs_list)
    return out_nds[0] if len(out_nds) == 1 else out_nds


def _gate(keep, t):
    from ..ops.control_flow_ops import gate

    return gate(keep, t)


def _make_op_func(op_name, func_name):
    def fn(*args, **kwargs):
        return invoke_nd(op_name, *args, **kwargs)

    fn.__name__ = func_name
    op = _reg.get_op(op_name)
    fn.__doc__ = (op.doc or f"Operator `{op_name}`.") + _reg.param_doc(op)
    return fn


def populate_op_namespaces(root_module_name="mxnet_tpu_torch.ndarray",
                           make_func=_make_op_func, tensor_type=NDArray):
    """Create the nd top level and nd.op / nd._internal / nd.linalg /
    nd.random / nd.contrib / nd.image from the registry: the analogue of
    the reference's import-time codegen (`_init_ops`). ``_random_x`` is
    ``random.x`` and ``_sample_x`` ``random.sample_x``; ``random.x`` of a
    distribution with both takes MXNet's route (`_random_frontend`) for
    arguments of ``tensor_type``."""
    root = sys.modules[root_module_name]
    sub = {}
    for ns in ("op", "_internal", "linalg", "random", "contrib", "image"):
        modname = f"{root_module_name}.{ns}"
        mod = sys.modules.get(modname)
        if mod is None:
            mod = sys.modules[modname] = types.ModuleType(modname)
        sub[ns] = mod
        setattr(root, ns, mod)

    prefixes = (("_linalg_", "linalg"), ("_random_", "random"),
                ("_contrib_", "contrib"), ("_image_", "image"))
    made = {}
    for name in _reg.list_ops():
        f = made[name] = make_func(name, name.lstrip("_"))
        setattr(sub["op"], name, f)
        for prefix, ns in prefixes:
            if name.startswith(prefix):
                setattr(sub[ns], name[len(prefix):], f)
        if name.startswith("_sample_"):
            setattr(sub["random"], name[1:], f)
        if name.startswith("_"):
            setattr(sub["_internal"], name, f)
        elif not hasattr(root, name):
            setattr(root, name, f)
    _random_frontend(sub["random"], made, tensor_type)
    # the legacy top-level names (``mx.nd.uniform``)
    for legacy in ("uniform", "normal", "randint"):
        setattr(root, legacy, getattr(sub["random"], legacy))


def _random_frontend(random, made, tensor_type):
    """MXNet's `random.x(params..., shape=, dtype=, ctx=, out=)`: number
    parameters draw through ``_random_x`` (one distribution), array
    parameters through ``_sample_x`` (one distribution a row), and a mix
    raises. ``multinomial`` and ``shuffle`` are MXNet's names of
    ``_sample_multinomial`` and ``_shuffle``."""
    for name in ("uniform", "normal", "gamma", "exponential", "poisson",
                 "negative_binomial", "generalized_negative_binomial"):
        scalar, rows = made["_random_" + name], made["_sample_" + name]
        params = _op_attr_params(_reg.get_op("_random_" + name))[0]
        params = params[:params.index("shape")]
        setattr(random, name, _dispatcher(name, scalar, rows, params,
                                          tensor_type))
    random.multinomial = made["_sample_multinomial"]
    random.shuffle = made["_shuffle"]


def _dispatcher(name, scalar, rows, params, tensor_type):
    def fn(*args, **kwargs):
        given = list(args[:len(params)]) + [kwargs[p] for p in
                                            params[len(args):] if p in kwargs]
        arrays = [isinstance(v, tensor_type) for v in given]
        if not any(arrays):
            return scalar(*args, **kwargs)
        if not all(arrays) or len(given) != len(params):
            raise MXNetError(
                f"random.{name}: the distribution's parameters "
                f"{params} must all be arrays or all be numbers")
        rest = {k: v for k, v in kwargs.items() if k not in params}
        return rows(*given, **rest)

    fn.__name__ = name
    fn.__doc__ = (f"Draws of the {name} distribution: `_random_{name}` for "
                  f"number parameters, `_sample_{name}` (one distribution "
                  f"a row) for arrays.")
    return fn
