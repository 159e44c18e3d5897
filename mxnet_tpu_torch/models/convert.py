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

Recurrent layers: a gluon RNN layer keeps each layer's and direction's
pieces (``l0_i2h_weight``, ``r1_h2h_bias``, ``l0_h2r_weight``); the fused
`RNN` op of a symbolic graph takes one flat vector (``lstm_parameters_weight``
in `example/rnn/lstm_bucketing.py`) in the reference's layout.
`rnn_flat_to_arrays` and `rnn_arrays_to_flat` convert between the two, so
either package's weights load into either form of the port.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..context import resolve_device

__all__ = ["params_from_jax", "params_to_jax", "port_name", "jax_name",
           "to_tensor", "state_like", "gluon_params_from_numpy",
           "rnn_flat_to_arrays", "rnn_arrays_to_flat"]

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


def _rnn_names(num_layers, bidirectional, projection_size):
    """The gluon layer's names of each (layer, direction)'s (i2h weight,
    h2h weight, i2h bias, h2h bias, h2r weight or None), in the flat
    vector's (layer, direction) order."""
    out = []
    for i in range(num_layers):
        for j in "lr"[:2 if bidirectional else 1]:
            out.append((f"{j}{i}_i2h_weight", f"{j}{i}_h2h_weight",
                        f"{j}{i}_i2h_bias", f"{j}{i}_h2h_bias",
                        f"{j}{i}_h2r_weight" if projection_size else None))
    return out


def rnn_flat_to_arrays(flat, num_layers, hidden_size, input_size, mode,
                       bidirectional=False, projection_size=None,
                       prefix=""):
    """{``prefix`` + gluon layer name: numpy array} of a gluon `RNN` /
    `LSTM` / `GRU` layer from the fused op's flat vector (numpy, or anything
    `np.asarray` takes), in the reference's layout (`ops.rnn`)."""
    from ..ops.rnn import _slice_params, rnn_param_size

    flat = np.asarray(flat)
    want = rnn_param_size(num_layers, hidden_size, input_size, mode,
                          bidirectional, projection_size)
    if flat.size != want:
        raise ValueError(f"flat vector of {flat.size} values, the layer "
                         f"takes {want}")
    pieces = _slice_params(to_tensor(flat.reshape(-1)), num_layers,
                           hidden_size, input_size, mode,
                           2 if bidirectional else 1, projection_size)
    out = {}
    for names, views in zip(_rnn_names(num_layers, bidirectional,
                                       projection_size), pieces):
        for name, view in zip(names, views):
            if name is not None:
                out[prefix + name] = view.numpy().copy()
    return out


def rnn_arrays_to_flat(arrays, num_layers, bidirectional=False,
                       projection_size=None, prefix=""):
    """The fused op's flat vector (numpy) from a gluon RNN layer's
    arrays by name (``prefix`` + ``l0_i2h_weight`` ...): all weights
    (layer-major, direction-minor, i2h then h2h), then all biases, then
    the projections."""
    names = _rnn_names(num_layers, bidirectional, projection_size)
    order = [n for ns in names for n in ns[:2]] + \
        [n for ns in names for n in ns[2:4]] + \
        [ns[4] for ns in names if ns[4] is not None]
    return np.concatenate([np.asarray(arrays[prefix + n]).reshape(-1)
                           for n in order])
