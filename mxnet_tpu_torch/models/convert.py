"""Carry weights between the JAX package and the port.

TransformerLM: the JAX package keeps a flat dict with names such as
``"embed"``, ``"l0.wqkv"`` and ``"ln_f_scale"``; the port's `TransformerLM`
is an `nn.Module`, whose parameter names cannot hold ``l0.wqkv`` as one
attribute, so layer ``i``'s weights live at ``layers.{i}.*``. Both keep the
same layouts, so a conversion is a rename and a copy.

gluon blocks: both packages name a block's parameters by their structural
names (``features.0.weight``, `Block._collect_params_with_prefix`), so
`gluon_params_from_numpy` sets them from a dict so keyed; `save_parameters`
files cross between the packages as they are.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..context import resolve_device

__all__ = ["params_from_jax", "params_to_jax", "port_name", "jax_name",
           "to_tensor", "state_like", "gluon_params_from_numpy"]

_JAX_LAYER = re.compile(r"^l(\d+)\.(\w+)$")
_PORT_LAYER = re.compile(r"^layers\.(\d+)\.(\w+)$")


def port_name(name: str) -> str:
    """``"l3.wqkv"`` -> ``"layers.3.wqkv"``; other names are unchanged."""
    m = _JAX_LAYER.match(name)
    return f"layers.{m.group(1)}.{m.group(2)}" if m else name


def jax_name(name: str) -> str:
    """``"layers.3.wqkv"`` -> ``"l3.wqkv"``; other names are unchanged."""
    m = _PORT_LAYER.match(name)
    return f"l{m.group(1)}.{m.group(2)}" if m else name


def to_tensor(arr) -> torch.Tensor:
    """A CPU tensor holding a copy of `arr` (anything `np.asarray` takes).
    A bf16 array, as the JAX package hands it out (``ml_dtypes``), or as
    ``np.load`` reads one that it saved (2-byte void elements), becomes a
    bf16 tensor of the same bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(np_params, device=None, dtype=None):
    """A state dict for the port's `TransformerLM` from the JAX package's
    flat params (numpy arrays or anything `np.asarray` takes, bf16 included).
    `device` follows `resolve_device` (``cuda`` unless the caller says
    otherwise); `dtype` casts every tensor, else each keeps its own. Load it
    with ``lm.load_state_dict(...)``."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        t = to_tensor(arr)
        out[port_name(name)] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def state_like(module, params, what):
    """``params`` (arrays or tensors, under the port's names or the JAX
    package's) as new tensors on the devices and in the dtypes of
    `module`'s parameters, which they must cover exactly, shape for shape;
    otherwise MXNetError, naming `what`. A weight swap copies these into
    the parameters that captured graphs read in place."""
    from ..base import MXNetError

    cur = dict(module.named_parameters())
    new = {port_name(str(k)): v for k, v in dict(params).items()}
    if set(new) != set(cur):
        raise MXNetError(
            f"{what}: parameter names differ from the bound set (missing "
            f"{sorted(set(cur) - set(new))}, unexpected "
            f"{sorted(set(new) - set(cur))})")
    out = {}
    for name, v in new.items():
        t = v.detach() if isinstance(v, torch.Tensor) else to_tensor(v)
        if tuple(t.shape) != tuple(cur[name].shape):
            raise MXNetError(f"{what}: parameter {name!r} has shape "
                             f"{tuple(t.shape)}, the bound one "
                             f"{tuple(cur[name].shape)}")
        out[name] = t.to(device=cur[name].device, dtype=cur[name].dtype,
                         copy=True)
    return out


def params_to_jax(state):
    """The JAX package's flat params (numpy arrays) from a port state dict or
    module. bf16 tensors come back as float32 arrays, which hold every bf16
    value exactly; cast them with ``.astype(jnp.bfloat16)``."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    out = {}
    for name, t in state.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[jax_name(name)] = t.numpy().copy()
    return out


def gluon_params_from_numpy(block, arrays, ctx=None):
    """Set a gluon block's parameters from ``{structural name: array}``
    (numpy arrays, or anything `np.asarray` takes), each cast to its
    parameter's dtype; a parameter not yet initialized is initialized from
    its array on ``ctx`` (its deferred context, else the CPU). Every
    parameter of the block must be given, and no other name."""
    from ..context import cpu
    from ..ndarray import array

    params = block._collect_params_with_prefix()
    if set(arrays) != set(params):
        raise ValueError(
            f"names differ: missing {sorted(set(params) - set(arrays))}, "
            f"unknown {sorted(set(arrays) - set(params))}")
    for name, value in arrays.items():
        value = np.asarray(value)
        params[name]._load_init(array(value, ctx=cpu(), dtype=value.dtype),
                                ctx)
