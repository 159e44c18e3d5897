"""Subgraph framework: pluggable graph partition-and-replace. The port of
`mxnet_tpu/symbol/subgraph.py` (parity `src/operator/subgraph/
subgraph_property.h`: `SubgraphSelector`:77, `SubgraphProperty`:111;
`build_subgraph.cc`, the partition pass; the
`MXNET_REGISTER_SUBGRAPH_PROPERTY` / `MXNET_SUBGRAPH_BACKEND` plumbing).

A selector walks the Symbol DAG growing connected regions; the property
replaces each region with a new node. The payoff is structural rewrites,
such as folding BatchNorm into a Convolution's weights (``TPU_FUSE``,
`fusion.py`). The default replacement is the opaque `_subgraph_exec` op,
whose attribute carries the region as Symbol JSON and which runs it
through the executor's graph function. The rewritten symbol's JSON text
is the JAX package's.
"""
from __future__ import annotations

import os

from ..base import MXNetError
from .symbol import Symbol, _Node

__all__ = ["SubgraphSelector", "SubgraphProperty", "register_subgraph_property",
           "get_subgraph_property", "list_subgraph_backends", "build_subgraph"]


class SubgraphSelector:
    """Decides which nodes join a subgraph (reference
    `subgraph_property.h:77`). The walk starts at a node where
    :meth:`select` is true, then grows along input edges accepted by
    :meth:`select_input` and consumer edges accepted by
    :meth:`select_output`; :meth:`filter` gets the final veto."""

    def select(self, node):
        return False

    def select_input(self, node, input_node):
        return False

    def select_output(self, node, output_node):
        return False

    def filter(self, candidates):
        """Return the (possibly trimmed) list of nodes to keep."""
        return candidates

    def reset(self):
        """Called before each new seed walk."""


class SubgraphProperty:
    """A backend's partition rule + replacement factory (reference
    `subgraph_property.h:111`)."""

    def create_subgraph_selector(self):
        return SubgraphSelector()

    def create_subgraph_node(self, subgraph_sym, input_entries, subgraph_id):
        """Return the replacement Symbol for a region.

        ``subgraph_sym``: the region as a Symbol whose free inputs are
        fresh variables; ``input_entries``: the Symbols from the OUTER
        graph feeding those variables, in the same order; ``subgraph_id``:
        ordinal of this region. The default wraps the region into one
        opaque `_subgraph_exec` node (CreateSubgraphNode role)."""
        from . import symbol as _sym_mod

        # args THEN aux states — the same order build_subgraph hands
        # input_entries over in; _graph_fn resolves either kind by name
        inner_args = (subgraph_sym.list_arguments()
                      + subgraph_sym.list_auxiliary_states())
        attrs = {
            "subgraph": subgraph_sym.tojson(),
            "arg_names": ",".join(inner_args),
            "n_out": len(subgraph_sym._outputs),
        }
        return _sym_mod._apply_op("_subgraph_exec", *input_entries,
                                  name=f"subgraph{subgraph_id}", **attrs)


_PROPERTIES = {}


def register_subgraph_property(backend, prop):
    """MXNET_REGISTER_SUBGRAPH_PROPERTY: register under a backend name.
    ``prop`` may be a SubgraphProperty instance or class."""
    _PROPERTIES[backend] = prop


def get_subgraph_property(backend):
    prop = _PROPERTIES.get(backend)
    if prop is None:
        raise MXNetError(f"unknown subgraph backend '{backend}'; "
                         f"registered: {sorted(_PROPERTIES)}")
    return prop() if isinstance(prop, type) else prop


def list_subgraph_backends():
    return sorted(_PROPERTIES)


# ---------------------------------------------------------------------------
# The partition pass (build_subgraph.cc role)
# ---------------------------------------------------------------------------


def _clone_graph(symbol):
    """Deep-clone the DAG so the rewrite never mutates the user's Symbol."""
    mapping = {}

    def clone(node):
        got = mapping.get(id(node))
        if got is not None:
            return got
        new = _Node(node.op, node.name, dict(node.attrs), [])
        mapping[id(node)] = new
        new.inputs = [(clone(c), i) for c, i in node.inputs]
        return new

    outs = [(clone(n), i) for n, i in symbol._outputs]
    return Symbol(outs)


def _consumers_map(nodes):
    cons = {}
    for n in nodes:
        for pos, (child, oidx) in enumerate(n.inputs):
            cons.setdefault(id(child), []).append((n, pos, oidx))
    return cons


def _reaches(src, targets_ids, block_ids, memo):
    """True if src reaches any node in targets_ids without passing through
    block_ids (DFS along input edges, i.e. from consumers to producers)."""
    key = id(src)
    if key in memo:
        return memo[key]
    if key in targets_ids:
        memo[key] = True
        return True
    if key in block_ids:
        memo[key] = False
        return False
    memo[key] = False  # cycle guard (DAG anyway)
    for child, _ in src.inputs:
        if _reaches(child, targets_ids, block_ids, memo):
            memo[key] = True
            break
    return memo[key]


def build_subgraph(symbol, prop):
    """Partition ``symbol`` with ``prop`` and replace each selected region
    (reference `build_subgraph.cc`). Returns a NEW Symbol; the input is
    untouched."""
    if isinstance(prop, str):
        prop = get_subgraph_property(prop)
    sym = _clone_graph(symbol)
    nodes = sym._nodes()
    consumers = _consumers_map(nodes)

    assigned = set()
    regions = []
    for seed in nodes:
        if seed.is_variable or id(seed) in assigned:
            continue
        selector = prop.create_subgraph_selector()
        selector.reset()
        if not selector.select(seed):
            continue
        region = [seed]
        region_ids = {id(seed)}
        frontier = [seed]
        while frontier:
            cur = frontier.pop()
            for child, _ in cur.inputs:
                if child.is_variable or id(child) in region_ids or \
                        id(child) in assigned:
                    continue
                if selector.select_input(cur, child):
                    region.append(child)
                    region_ids.add(id(child))
                    frontier.append(child)
            for cons, _pos, _oidx in consumers.get(id(cur), ()):
                if id(cons) in region_ids or id(cons) in assigned:
                    continue
                if selector.select_output(cur, cons):
                    region.append(cons)
                    region_ids.add(id(cons))
                    frontier.append(cons)
        region = selector.filter(region)
        region_ids = {id(n) for n in region}
        if not region:
            continue
        # convexity: collapsing the region must not create a cycle — no
        # path from a region output through OUTSIDE nodes back into the
        # region (build_subgraph.cc's cycle check)
        convex = True
        for n in region:
            for cons, _pos, _oidx in consumers.get(id(n), ()):
                if id(cons) in region_ids:
                    continue
                # does this outside consumer feed back into the region?
                # fresh memo per target: _reaches caches per-target results,
                # reuse across different cons would mask cycles
                memo = {}
                for other in nodes:
                    if id(other) in region_ids:
                        for child, _ in other.inputs:
                            if id(child) not in region_ids and \
                                    _reaches(child, {id(cons)}, region_ids, memo):
                                convex = False
                                break
                    if not convex:
                        break
                if not convex:
                    break
            if not convex:
                break
        if not convex:
            continue
        assigned |= region_ids
        regions.append(region)

    if not regions:
        return sym

    for sid, region in enumerate(regions):
        _replace_region(sym, sym._nodes(), _consumers_map(sym._nodes()),
                        region, prop, sid)
    return sym


def _replace_region(sym, nodes, consumers, region, prop, sid):
    region_ids = {id(n) for n in region}
    topo = [n for n in nodes if id(n) in region_ids]  # region in topo order

    # external inputs feeding the region, stable order, dedup
    ext_inputs = []
    ext_index = {}
    for n in topo:
        for child, oidx in n.inputs:
            if id(child) in region_ids:
                continue
            key = (id(child), oidx)
            if key not in ext_index:
                ext_index[key] = len(ext_inputs)
                ext_inputs.append((child, oidx))

    # region outputs consumed outside (or by the symbol's heads)
    head_ids = {(id(n), i) for n, i in sym._outputs}
    ext_outputs = []
    out_index = {}
    for n in topo:
        for i in range(n.num_outputs()):
            used_outside = (id(n), i) in head_ids or any(
                id(c) not in region_ids
                for c, _p, oi in consumers.get(id(n), ()) if oi == i)
            if used_outside and (id(n), i) not in out_index:
                out_index[(id(n), i)] = len(ext_outputs)
                ext_outputs.append((n, i))

    # build the inner symbol: clone region nodes, free inputs → variables.
    # Variable names must be unique so input_entries can be re-aligned with
    # list_arguments() order (what SubgraphProperty implementations see).
    inner_map = {}
    inner_vars = []
    used_names = set()
    for idx, (child, oidx) in enumerate(ext_inputs):
        vname = child.name if child.is_variable else f"{child.name}_out{oidx}"
        if vname in used_names:
            vname = f"{vname}_{idx}"
        used_names.add(vname)
        v = _Node(None, vname)
        inner_vars.append(v)
        inner_map[(id(child), oidx)] = (v, 0)

    def inner_clone(node):
        got = inner_map.get(id(node))
        if got is not None:
            return got
        new = _Node(node.op, node.name, dict(node.attrs), [])
        inner_map[id(node)] = new
        ins = []
        for child, oidx in node.inputs:
            if id(child) in region_ids:
                ins.append((inner_clone(child), oidx))
            else:
                ins.append(inner_map[(id(child), oidx)])
        new.inputs = ins
        return new

    inner_outs = [(inner_clone(n), i) for n, i in ext_outputs]
    inner_sym = Symbol(inner_outs)

    # align the outer entries with the inner symbol's list_arguments()
    # order — THE contract SubgraphProperty implementations rely on
    by_name = {v.name: Symbol([(c, i)])
               for v, (c, i) in zip(inner_vars, ext_inputs)}
    input_entries = [by_name[n] for n in (inner_sym.list_arguments()
                                          + inner_sym.list_auxiliary_states())]
    replacement = prop.create_subgraph_node(inner_sym, input_entries, sid)
    if replacement is None:
        return  # property declined this region (Filter-at-create veto)
    if len(replacement._outputs) != len(ext_outputs):
        raise MXNetError(
            f"subgraph property returned {len(replacement._outputs)} outputs "
            f"for a region with {len(ext_outputs)} external outputs")

    # rewrite outer edges: (region node, out idx) -> replacement entry
    repl = {(id(n), i): replacement._outputs[j]
            for j, (n, i) in enumerate(ext_outputs)}
    for n in sym._nodes():
        if id(n) in region_ids:
            continue
        n.inputs = [repl.get((id(c), i), (c, i)) for c, i in n.inputs]
    sym._outputs = [repl.get((id(n), i), (n, i)) for n, i in sym._outputs]


def apply_env_backend(symbol):
    """Apply `MXNET_SUBGRAPH_BACKEND` if it names a registered backend, and
    leave the symbol alone otherwise (the bind-time hook, reference
    `build_subgraph.cc` and its executor integration). Serving applies
    ``TPU_FUSE`` by default (`serving/predictor.py`); a training bind only
    when the variable is set."""
    backend = os.environ.get("MXNET_SUBGRAPH_BACKEND")
    if not backend or backend in ("NONE", "0"):
        return symbol
    if backend not in _PROPERTIES:
        return symbol
    return build_subgraph(symbol, backend)
