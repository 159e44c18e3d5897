"""Symbolic control flow, `mx.sym.contrib.foreach / while_loop / cond`: the
port of `mxnet_tpu/symbol/control_flow.py` (parity
`python/mxnet/symbol/contrib.py`, which cuts NNVM subgraphs and deduces
their inputs).

The body callables build a Symbol sub-DAG over placeholder variables; its
free variables (the weights a body closes over) are the sub-DAG's other
variable leaves, wired in as extra inputs of the node, so binding and the
gradient treat them as any other input. The subgraph travels as a JSON
attribute and runs in `ops/control_flow_ops.py`.
"""
from __future__ import annotations

import itertools

from ..base import flatten_nested, unflatten_nested
from .symbol import Group, Symbol, _Node, _topo_order, var

__all__ = ["foreach", "while_loop", "cond"]

_uid = itertools.count()


def _flatten(x):
    return flatten_nested(x, Symbol)


def _free_vars(heads, placeholder_names):
    """The sub-DAG's variable leaves that are not placeholders, in
    topological order."""
    return [node for node in _topo_order([n for n, _ in heads._outputs])
            if node.is_variable and node.name not in placeholder_names]


def _var_names(heads):
    return [n.name for n in _topo_order([x for x, _ in heads._outputs])
            if n.is_variable]


def _outputs_of(node, n):
    return [Symbol([(node, i)]) for i in range(n)]


def _unique(nodes, taken=()):
    out, seen = [], set(taken)
    for f in nodes:
        if f.name not in seen:
            seen.add(f.name)
            out.append(f)
    return out


def foreach(body, data, init_states, name=None):
    """Symbolic foreach (reference `_foreach`, control_flow.cc:1255)."""
    name = name or f"foreach{next(_uid)}"
    data_l, data_struct = _flatten(data)
    states_l, states_struct = _flatten(init_states)
    if not data_l:
        raise ValueError("foreach: data must contain at least one symbol")
    slice_vars = [var(f"{name}_slice{i}") for i in range(len(data_l))]
    state_vars = [var(f"{name}_state{i}") for i in range(len(states_l))]
    out, new_s = body(unflatten_nested(slice_vars, data_struct),
                      unflatten_nested(state_vars, states_struct))
    out_l, out_struct = _flatten(out)
    ns_l, ns_struct = _flatten(new_s)
    if len(ns_l) != len(states_l):
        raise ValueError(f"foreach: body returned {len(ns_l)} states, "
                         f"expected {len(states_l)}")
    sub = Group(out_l + ns_l)
    ph = [s._outputs[0][0].name for s in slice_vars + state_vars]
    frees = _free_vars(sub, set(ph))
    inputs = [s._outputs[0] for s in data_l + states_l] + \
        [(f, 0) for f in frees]
    attrs = {"subgraph": sub.tojson(),
             "sub_args": ",".join(ph + [f.name for f in frees]),
             "n_data": len(data_l), "n_states": len(states_l),
             "n_out": len(out_l), "__opt_in__": ""}
    outs = _outputs_of(_Node("_foreach", name, attrs, inputs),
                       len(out_l) + len(ns_l))
    outputs = unflatten_nested(outs[:len(out_l)], out_struct) if out_l \
        else []
    states = unflatten_nested(outs[len(out_l):], ns_struct) if ns_l else []
    return outputs, states


def while_loop(cond, func, loop_vars, max_iterations=None, name=None):
    """Symbolic while_loop (reference `_while_loop`, control_flow.cc:1316),
    bounded by ``max_iterations``: step outputs are stacked to
    (max_iterations, ...) with zero rows past the stop."""
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    name = name or f"while{next(_uid)}"
    lv_l, lv_struct = _flatten(loop_vars)
    if not lv_l:
        raise ValueError("while_loop: loop_vars must be non-empty")
    lv_vars = [var(f"{name}_lv{i}") for i in range(len(lv_l))]
    lv_args = unflatten_nested(lv_vars, lv_struct)
    lv_list = lv_args if isinstance(lv_args, list) else [lv_args]
    c_sym = cond(*lv_list)
    if not isinstance(c_sym, Symbol):
        raise TypeError("while_loop: cond must return a Symbol")
    out, new_lv = func(*lv_list)
    out_l, out_struct = _flatten(out)
    nl_l, _ = _flatten(new_lv)
    if len(nl_l) != len(lv_l):
        raise ValueError(f"while_loop: func returned {len(nl_l)} loop_vars, "
                         f"expected {len(lv_l)}")
    body_sub = Group(out_l + nl_l)
    lv_names = [v._outputs[0][0].name for v in lv_vars]
    ph = set(lv_names)
    free_nodes = _unique(_free_vars(c_sym, ph) + _free_vars(body_sub, ph),
                         lv_names)
    inputs = [s._outputs[0] for s in lv_l] + [(f, 0) for f in free_nodes]
    attrs = {"cond_subgraph": c_sym.tojson(),
             "body_subgraph": body_sub.tojson(),
             "cond_args": ",".join(_var_names(c_sym)),
             "body_args": ",".join(_var_names(body_sub)),
             "lv_names": ",".join(lv_names),
             "n_lv": len(lv_l), "n_out": len(out_l),
             "max_iterations": int(max_iterations)}
    outs = _outputs_of(_Node("_while_loop", name, attrs, inputs),
                       len(out_l) + len(lv_l))
    outputs = unflatten_nested(outs[:len(out_l)], out_struct) if out_l \
        else []
    return outputs, unflatten_nested(outs[len(out_l):], lv_struct)


def cond(pred, then_func, else_func, name=None):
    """Symbolic cond (reference `_cond`, control_flow.cc:1378)."""
    name = name or f"cond{next(_uid)}"
    if not isinstance(pred, Symbol):
        raise TypeError("cond: pred must be a Symbol")
    t_l, t_struct = _flatten(then_func())
    e_l, _ = _flatten(else_func())
    if len(t_l) != len(e_l):
        raise ValueError("cond: then/else must return the same number of "
                         "outputs")
    t_sub, e_sub = Group(t_l), Group(e_l)
    free_nodes = _unique(_free_vars(t_sub, set()) + _free_vars(e_sub, set()))
    inputs = [pred._outputs[0]] + [(f, 0) for f in free_nodes]
    attrs = {"then_subgraph": t_sub.tojson(),
             "else_subgraph": e_sub.tojson(),
             "then_args": ",".join(_var_names(t_sub)),
             "else_args": ",".join(_var_names(e_sub)),
             "n_out": len(t_l)}
    outs = _outputs_of(_Node("_cond", name, attrs, inputs), len(t_l))
    return unflatten_nested(outs, t_struct)
