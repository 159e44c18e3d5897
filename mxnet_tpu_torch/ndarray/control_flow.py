"""Imperative control flow, `mx.nd.contrib.foreach / while_loop / cond`: the
port of `mxnet_tpu/ndarray/control_flow.py` (parity the reference's
`python/mxnet/ndarray/contrib.py`).

The JAX package traces each body once into `lax.scan` / a masked scan /
`lax.cond`. Here the bodies are Python callables run eagerly under the
port's autograd, with the JAX package's semantics and output structure:

- `foreach` runs the body once a step and stacks its outputs.
- `while_loop` is the JAX package's bounded loop: ``max_iterations``
  steps under an ``active`` flag kept on the device (never read on the
  host), the loop variables frozen and the outputs zero once it falls.
- `cond` runs both branches and selects by the predicate on the device.

Neither reads a value on the host, so a hybridized block that holds them
can be captured. While the body of `while_loop` or a branch of `cond`
runs, every array an op reads passes the gradient gate of
`ops.control_flow_ops` (`register._CF_KEEP`): the gradient reaches it only
where the loop was active or the branch taken, so a non-finite value in
the branch not taken stays out of every gradient, the arrays the body
closes over (a layer's weights) included.

A gluon block inside a body initializes its deferred parameters at the
first step, as any eager call does; the JAX package's warm-up call
(``control_flow.py:44-49``) is there to keep tracers out of parameter
storage, which eager torch has no need of.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..base import flatten_nested, unflatten_nested
from ..ops.control_flow_ops import gate, select
from . import register as _register
from .ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _flatten(x):
    return flatten_nested(x, NDArray)


def _stack(arrays):
    return _register.invoke_nd("stack", *arrays, axis=0,
                               num_args=len(arrays))


class _Gated:
    """Inside the block every op's NDArray inputs pass the gate of ``keep``
    (and of any enclosing gate)."""

    def __init__(self, keep):
        outer = _register._CF_KEEP.get()
        self.keep = keep if outer is None else torch.logical_and(outer, keep)

    def __enter__(self):
        self.token = _register._CF_KEEP.set(self.keep)
        return self

    def __exit__(self, *exc):
        _register._CF_KEEP.reset(self.token)


def _note(nds):
    if autograd.is_recording():
        for a in nds:
            autograd._note_input(a)


def _scalar_bool(a):
    return a._data.reshape(()).to(torch.bool)


def foreach(body, data, init_states, name="foreach"):
    """Run ``body(data_slice, states) -> (outputs, new_states)`` over the
    leading axis of ``data``; outputs are stacked along a new leading axis
    (reference `_foreach`, control_flow.cc:1255)."""
    data_l, data_struct = _flatten(data)
    states_l, states_struct = _flatten(init_states)
    if not data_l:
        raise ValueError("foreach: data must contain at least one NDArray")
    states = unflatten_nested(states_l, states_struct) if states_l \
        else init_states
    steps, out_struct, ns_struct = [], None, states_struct
    for t in range(data_l[0].shape[0]):
        x_t = unflatten_nested([d[t] for d in data_l], data_struct)
        out, states = body(x_t, states)
        out_l, out_struct = _flatten(out)
        ns_l, ns_struct = _flatten(states)
        if len(ns_l) != len(states_l):
            raise ValueError(f"foreach: body returned {len(ns_l)} states, "
                             f"expected {len(states_l)}")
        steps.append(out_l)
    outputs = [_stack([s[k] for s in steps]) for k in range(len(steps[0]))]
    outputs = unflatten_nested(outputs, out_struct) if outputs else []
    ns_l, _ = _flatten(states)
    states = unflatten_nested(ns_l, ns_struct) if ns_l else []
    return outputs, states


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """``while cond(*loop_vars): outputs, loop_vars = func(*loop_vars)``,
    bounded by ``max_iterations`` (reference `_while_loop`,
    control_flow.cc:1316). Step outputs are stacked to (max_iterations,
    ...), zero past the last step. Returns (outputs, final loop_vars)."""
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations (a static "
                         "trip count)")
    lv_l, lv_struct = _flatten(loop_vars)
    if not lv_l:
        raise ValueError("while_loop: loop_vars must be non-empty")
    _note(lv_l)
    recording = autograd.is_recording()
    active = torch.ones((), dtype=torch.bool, device=lv_l[0]._data.device)
    steps, out_struct = [], None
    lv = [a._data for a in lv_l]
    for _ in range(int(max_iterations)):
        lv_nd = unflatten_nested([NDArray(t) for t in lv], lv_struct)
        lv_list = lv_nd if isinstance(lv_nd, list) else [lv_nd]
        active = torch.logical_and(active, _scalar_bool(cond(*lv_list)))
        with _Gated(active), torch.set_grad_enabled(recording):
            gated = unflatten_nested([NDArray(gate(active, t)) for t in lv],
                                     lv_struct)
            out, new_lv = func(*(gated if isinstance(gated, list)
                                 else [gated]))
        out_l, out_struct = _flatten(out)
        nl_l, _ = _flatten(new_lv)
        if len(nl_l) != len(lv):
            raise ValueError(f"while_loop: func returned {len(nl_l)} "
                             f"loop_vars, expected {len(lv)}")
        with torch.set_grad_enabled(recording):
            steps.append([select(active, o._data, torch.zeros_like(o._data))
                          for o in out_l])
            lv = [select(active, n._data, o) for n, o in zip(nl_l, lv)]
    with torch.set_grad_enabled(recording):
        outputs = [NDArray(torch.stack([s[k] for s in steps]))
                   for k in range(len(steps[0]) if steps else 0)]
    outputs = unflatten_nested(outputs, out_struct) if outputs else []
    return outputs, unflatten_nested([NDArray(t) for t in lv], lv_struct)


def cond(pred, then_func, else_func, name="cond"):
    """``then_func() if pred else else_func()`` (reference `_cond`,
    control_flow.cc:1378): both branches run, each behind its gate, and
    the outputs are selected on the device. Both must return the same
    structure and shapes."""
    if not isinstance(pred, NDArray):
        raise TypeError("cond: pred must be an NDArray scalar")
    pv = _scalar_bool(pred)
    recording = autograd.is_recording()
    results = []
    for func, keep in ((then_func, pv), (else_func, torch.logical_not(pv))):
        with _Gated(keep):
            results.append(_flatten(func()))
    (t_l, t_struct), (e_l, _) = results
    if len(t_l) != len(e_l):
        raise ValueError("cond: then/else must return the same number of "
                         "outputs")
    with torch.set_grad_enabled(recording):
        outs = [NDArray(select(pv, t._data, e._data))
                for t, e in zip(t_l, e_l)]
    return unflatten_nested(outs, t_struct)
