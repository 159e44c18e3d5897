"""Symbol, the declarative graph: the port of `mxnet_tpu/symbol/symbol.py`
(parity `python/mxnet/symbol/symbol.py`).

A Symbol is a small Python DAG over the same op registry the NDArray path
uses (`ops/registry.py`). Binding it (`bind`, `simple_bind`) makes an
`Executor`, which runs the graph as one function of tensors; its training
step is one captured CUDA graph on a card (`executor.py`). Shape inference
runs each node's op on ``meta`` tensors (`ops.registry.infer`), where the
JAX package calls ``jax.eval_shape``, with the same parameter back-fill
rules. The JSON text (`tojson`, the ``prefix-symbol.json`` of a checkpoint)
is the JAX package's, character for character, so checkpoints and
`HybridBlock.export` files cross between the packages.
"""
from __future__ import annotations

import ast
import inspect
import json

import numpy as _np

from .. import attribute as _attribute
from .. import name as _name_mod
from ..base import MXNetError, dtype_name
from ..ops import registry as _reg

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json"]

_MXNET_VERSION = 10500  # wire-format version stamp (reference libinfo 1.5.0)


def _op_input_spec(op):
    """(required_names, optional_name, varargs, aux_indices) for an op fn.

    Tensor inputs are the fn's positional parameters without a default
    (less the generator of an op that draws random numbers); a
    ``*maybe_x`` varargs declares ONE optional trailing input named x (the
    reference's no_bias-style optionals); any other varargs accepts any
    number of inputs (Concat style)."""
    try:
        sig = inspect.signature(op.fn)
    except (TypeError, ValueError):
        return ["data"], None, True, ()
    required, optional, open_varargs = [], None, False
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD and \
                p.default is inspect.Parameter.empty:
            required.append(p.name)
        elif p.kind is inspect.Parameter.VAR_POSITIONAL:
            if p.name.startswith("maybe_"):
                optional = p.name[len("maybe_"):]
            else:
                open_varargs = True
    if op.needs_rng and required:
        required = required[1:]
    aux = () if callable(op.mutate_aux) else tuple(op.mutate_aux or ())
    return required, optional, open_varargs, aux


class _Node:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, op, name, attrs=None, inputs=None):
        self.op = op                      # op name string or None (variable)
        self.name = name
        self.attrs = dict(attrs or {})    # python-typed values
        self.inputs = list(inputs or ())  # [(node, out_index)]

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        if self.is_variable:
            return 1
        return _reg.get_op(self.op).n_out(dict(self.attrs))

    def aux_input_indices(self):
        if self.is_variable:
            return ()
        aux = _reg.get_op(self.op).mutate_aux
        if callable(aux):
            aux = aux(dict(self.attrs))
        return tuple(aux or ())


def _topo_order(head_nodes):
    """Post-order DFS (stable, iterative) over the DAG."""
    order, seen = [], set()
    stack = [(n, False) for n in reversed(head_nodes)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in seen:
            continue
        if expanded:
            seen.add(id(node))
            order.append(node)
        else:
            stack.append((node, True))
            for child, _ in reversed(node.inputs):
                if id(child) not in seen:
                    stack.append((child, False))
    return order


class Symbol:
    """An immutable multi-output handle into the graph."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # [(node, out_index)]

    # -- identity ------------------------------------------------------------

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        n = self.name
        return f"<Symbol {n if n else 'Grouped'}>"

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError(f"no output named {index}; outputs: {names}")
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def get_internals(self):
        """A Symbol whose outputs are every output of every node."""
        outs = []
        for node in self._nodes():
            outs.extend((node, i) for i in range(node.num_outputs()))
        return Symbol(outs)

    def get_children(self):
        nodes = {id(n): n for n, _ in self._outputs}
        children = []
        for n in nodes.values():
            children.extend(n.inputs)
        return Symbol(children) if children else None

    # -- attrs ---------------------------------------------------------------

    def attr(self, key):
        if len(self._outputs) == 1:
            v = self._outputs[0][0].attrs.get(key)
            return None if v is None else str(v)
        return None

    def list_attr(self):
        if len(self._outputs) != 1:
            return {}
        node = self._outputs[0][0]
        return {k: str(v) for k, v in node.attrs.items()
                if k.startswith("__") or node.is_variable}

    def attr_dict(self):
        out = {}
        for node in self._nodes():
            if node.attrs:
                out[node.name] = {k: str(v) for k, v in node.attrs.items()}
        return out

    def _set_attr(self, **kwargs):
        for n, _ in self._outputs:
            n.attrs.update(kwargs)

    # -- listing -------------------------------------------------------------

    def _nodes(self):
        return _topo_order([n for n, _ in self._outputs])

    def _arg_aux_split(self):
        """Variables in graph order, split into (args, auxs) by whether any
        consumer uses them in an aux slot (the reference's FMutateInputs
        rule)."""
        aux_ids = set()
        nodes = self._nodes()
        for node in nodes:
            for ai in node.aux_input_indices():
                if ai < len(node.inputs):
                    child, _ = node.inputs[ai]
                    if child.is_variable:
                        aux_ids.add(id(child))
        args = [n for n in nodes if n.is_variable and id(n) not in aux_ids]
        auxs = [n for n in nodes if n.is_variable and id(n) in aux_ids]
        return args, auxs

    def list_arguments(self):
        return [n.name for n in self._arg_aux_split()[0]]

    def list_auxiliary_states(self):
        return [n.name for n in self._arg_aux_split()[1]]

    def list_inputs(self):
        return [n.name for n in self._nodes() if n.is_variable]

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.num_outputs() == 1:
                names.append(node.name if node.is_variable
                             else node.name + "_output")
            else:
                names.append(f"{node.name}_output{idx}")
        return names

    # -- composition sugar ---------------------------------------------------

    def __call__(self, *args, **kwargs):
        raise NotImplementedError("symbol re-composition via __call__ is not "
                                  "supported; build the graph with op calls")

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    # arithmetic: the registered broadcast and scalar ops, so the symbolic
    # and imperative paths share their functions
    def __add__(self, other):
        return _binary(self, other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _binary(self, other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _binary(self, other, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, other):
        return _binary(self, other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(self, other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _binary(self, other, "broadcast_div", "_rdiv_scalar")

    def __pow__(self, other):
        return _binary(self, other, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _binary(self, -1.0, None, "_mul_scalar")

    def __eq__(self, other):  # noqa: PLR0124 — symbolic eq builds a node
        return _binary(self, other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return _binary(self, other, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return _binary(self, other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return _binary(self, other, "broadcast_greater_equal",
                       "_greater_equal_scalar")

    def __lt__(self, other):
        return _binary(self, other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _binary(self, other, "broadcast_lesser_equal",
                       "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def reshape(self, shape, **kwargs):
        from . import op as _op
        return _op.reshape(self, shape=shape, **kwargs)

    def astype(self, dtype):
        from . import op as _op
        return _op.cast(self, dtype=dtype)

    # -- serialization -------------------------------------------------------

    def tojson(self, remove_amp_cast=True):
        nodes = self._nodes()
        node_index = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        arg_nodes = []
        for i, n in enumerate(nodes):
            entry = {
                "op": "null" if n.is_variable else n.op,
                "name": n.name,
                "inputs": [[node_index[id(c)], oi, 0] for c, oi in n.inputs],
            }
            if n.attrs:
                entry["attrs"] = {k: _attr_to_str(v)
                                  for k, v in n.attrs.items()}
            if n.is_variable:
                arg_nodes.append(i)
            out_nodes.append(entry)
        heads = [[node_index[id(n)], oi, 0] for n, oi in self._outputs]
        graph = {
            "nodes": out_nodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": heads,
            "attrs": {"mxnet_version": ["int", _MXNET_VERSION]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname, remove_amp_cast=True):
        with open(fname, "w") as f:
            f.write(self.tojson(remove_amp_cast=remove_amp_cast))

    # -- shape/type inference ------------------------------------------------

    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes, unknown = \
            self._infer_shape_impl(*args, **kwargs)
        if unknown:
            raise MXNetError(f"cannot fully infer shapes; unknown: {unknown}")
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes, _ = \
            self._infer_shape_impl(*args, **kwargs)
        return arg_shapes, out_shapes, aux_shapes

    def _infer_shape_impl(self, *args, **kwargs):
        if args:
            names = self.list_arguments()
            for n, s in zip(names, args):
                if s is not None:
                    kwargs.setdefault(n, s)
        known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
        shapes = _infer_graph_shapes(self, known)
        arg_nodes, aux_nodes = self._arg_aux_split()
        arg_shapes = [shapes.get((id(n), 0)) for n in arg_nodes]
        aux_shapes = [shapes.get((id(n), 0)) for n in aux_nodes]
        out_shapes = [shapes.get((id(n), oi)) for n, oi in self._outputs]
        unknown = [n.name for n, s in zip(arg_nodes, arg_shapes) if s is None]
        unknown += [n.name for n, s in zip(aux_nodes, aux_shapes)
                    if s is None]
        return arg_shapes, out_shapes, aux_shapes, unknown

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types); float32 by default (the
        reference's type inference with its default dtype)."""
        names = self.list_arguments()
        given = dict(zip(names, args)) if args else dict(kwargs)
        arg_types = [_np.dtype(given.get(n, "float32")) for n in names]
        aux_types = [_np.dtype("float32")] * len(self.list_auxiliary_states())
        out_types = [_np.dtype(given.get(names[0], "float32")) if names
                     else _np.dtype("float32")] * len(self._outputs)
        return arg_types, out_types, aux_types

    # -- binding -------------------------------------------------------------

    def get_backend_symbol(self, backend):
        """This symbol rewritten by a registered subgraph backend (reference
        symbol.py get_backend_symbol -> MXGenBackendSubgraph)."""
        from .subgraph import build_subgraph

        return build_subgraph(self, backend)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from .executor import Executor
        from .subgraph import apply_env_backend

        new_sym = apply_env_backend(self)
        if new_sym is not self:
            # a rewrite may move values between the arg and aux roles
            # (TPU_FUSE makes BatchNorm's moving stats arguments of the
            # folded node): split the caller's values again by the new
            # symbol's lists
            pool = {}
            for given, names in ((args, self.list_arguments()),
                                 (aux_states,
                                  self.list_auxiliary_states())):
                if isinstance(given, dict):
                    pool.update(given)
                elif isinstance(given, (list, tuple)):
                    pool.update(zip(names, given))
            if pool:
                args = {n: pool[n] for n in new_sym.list_arguments()
                        if n in pool}
                aux_states = {n: pool[n]
                              for n in new_sym.list_auxiliary_states()
                              if n in pool}
            if isinstance(args_grad, (list, tuple)):
                args_grad = dict(zip(self.list_arguments(), args_grad))
        return Executor(new_sym, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Infer every argument shape from the given input shapes, allocate
        zero-filled arrays on ``ctx`` (default: the current context) and
        bind (reference symbol.py:1376)."""
        from ..ndarray import zeros
        from .executor import Executor
        from .subgraph import apply_env_backend

        sym = apply_env_backend(self)
        arg_shapes, _, aux_shapes = sym.infer_shape(**kwargs)
        arg_names = sym.list_arguments()
        aux_names = sym.list_auxiliary_states()
        type_dict = type_dict or {}
        args = {n: zeros(s, ctx=ctx, dtype=type_dict.get(n, "float32"))
                for n, s in zip(arg_names, arg_shapes)}
        auxs = {n: zeros(s, ctx=ctx, dtype=type_dict.get(n, "float32"))
                for n, s in zip(aux_names, aux_shapes)}
        args_grad = None
        if grad_req != "null":
            args_grad = {n: zeros(s, ctx=ctx)
                         for n, s in zip(arg_names, arg_shapes)}
        return Executor(sym, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=auxs)

    # -- eval ----------------------------------------------------------------

    def eval(self, ctx=None, **kwargs):
        return self.bind(ctx, args=kwargs).forward()

    def debug_str(self):
        lines = []
        for n in self._nodes():
            kind = "Variable" if n.is_variable else n.op
            ins = ", ".join(f"{c.name}[{oi}]" for c, oi in n.inputs)
            lines.append(f"{kind} {n.name} <- [{ins}]")
        return "\n".join(lines)


def _attr_to_str(v):
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return f"({v[0]},)"  # "(64)" would literal_eval to a scalar
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


def _attr_from_str(s):
    if not isinstance(s, str):
        return s
    low = s.strip()
    if low in ("True", "true"):
        return True
    if low in ("False", "false"):
        return False
    try:
        return ast.literal_eval(low)
    except (ValueError, SyntaxError):
        return s


# -- construction -----------------------------------------------------------

def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """A variable symbol (reference symbol.py var/Variable)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = dict(_attribute.current().get(attr) or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    if stype is not None:
        attrs["__storage_type__"] = stype
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs), 0)])


Variable = var


def Group(symbols):
    outs = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Expected a list of symbols")
        outs.extend(s._outputs)
    return Symbol(outs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    graph = json.loads(json_str)
    nodes = []
    for entry in graph["nodes"]:
        op = entry["op"]
        attrs_raw = entry.get("attrs", entry.get("param", {})) or {}
        attrs = {k: _attr_from_str(v) for k, v in attrs_raw.items()}
        node = _Node(None if op == "null" else op, entry["name"], attrs)
        node.inputs = [(nodes[i], oi) for i, oi, *_ in entry["inputs"]]
        nodes.append(node)
    return Symbol([(nodes[i], oi) for i, oi, *_ in graph["heads"]])


# -- op application (called by the generated namespace) ----------------------

def _apply_op(op_name, *args, name=None, attr=None, **kwargs):
    """A graph node for `op_name`, with the parameter variables it is not
    given made the MXNet way (``fc1`` → ``fc1_weight``, ``fc1_bias``)."""
    op = _reg.get_op(op_name)
    required, optional, open_varargs, aux_idx = _op_input_spec(op)

    name = _name_mod.current().get(name, op_name.lstrip("_").lower())

    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    attrs = {k: v for k, v in kwargs.items()
             if not isinstance(v, Symbol) and v is not None}
    # unknown keywords are errors (the dmlc::Parameter Init role), checked
    # BEFORE merging attr=, which carries arbitrary node metadata
    _reg.validate_attrs(op, attrs)
    if attr:
        attrs.update(attr)

    pos_syms = [a for a in args if isinstance(a, Symbol)]
    # a None positional is skipped (gluon passes bias=None for no_bias
    # layers); any other non-symbol positional is refused
    if any(not isinstance(a, Symbol) and a is not None for a in args):
        raise MXNetError(f"{op_name}: positional non-symbol args not "
                         f"supported in symbol API; pass as keywords")

    if open_varargs:
        inputs = [s._outputs[0] for s in pos_syms]
        inputs += [v._outputs[0] for v in sym_kwargs.values()]
    else:
        inputs = []
        pos_iter = iter(pos_syms)
        no_bias = bool(attrs.get("no_bias", False))
        names = list(required)
        if optional is not None and not no_bias:
            names.append(optional)
        n_pos_used = 0
        for in_name in names:
            s = sym_kwargs.pop(in_name, None)
            if s is None:
                s = next(pos_iter, None)
                n_pos_used += s is not None
            if s is None:
                s = var(f"{name}_{in_name}")
            if len(s._outputs) != 1:
                raise MXNetError(f"{op_name} input {in_name}: grouped symbol "
                                 f"cannot be an op input")
            inputs.append(s._outputs[0])
        leftover = list(pos_iter)
        if op.tensor_opts:
            # the optional tensor inputs: the positional tail (a None keeps
            # its slot) or keywords, recorded by name
            tail, seen = [], 0
            for a in args:
                seen += isinstance(a, Symbol)
                if seen > n_pos_used or (a is None and seen == n_pos_used):
                    tail.append(a)
            if len(tail) > len(op.tensor_opts):
                raise MXNetError(f"{op_name}: too many symbol inputs")
            tail += [None] * (len(op.tensor_opts) - len(tail))
            bound = []
            for slot, a in zip(op.tensor_opts, tail):
                s = sym_kwargs.pop(slot, None)
                s = a if s is None else s
                if s is not None:
                    inputs.append(s._outputs[0])
                    bound.append(slot)
            if bound:
                attrs["__opt_in__"] = ",".join(bound)
            leftover = []
        if leftover or sym_kwargs:
            raise MXNetError(f"{op_name}: too many symbol inputs "
                             f"(leftover={len(leftover)}, "
                             f"kw={list(sym_kwargs)})")

    node = _Node(op_name, name, attrs, inputs)
    n_out = node.num_outputs()
    # multi-output stateful ops (BatchNorm) expose only the primary output
    # for composition; the other outputs are the aux write-backs
    if aux_idx and n_out > 1:
        return Symbol([(node, 0)])
    return Symbol([(node, i) for i in range(n_out)])


# -- shape inference over the graph ------------------------------------------

def _infer_graph_shapes(sym, known):
    """Forward shape propagation with per-op parameter back-fill rules.

    Walks topo order; a node whose data input's shape is known back-fills
    its parameter variables' shapes by `_PARAM_SHAPE_RULES` (the role of
    the reference's bidirectional FInferShape)."""
    shapes: dict = {}
    nodes = _topo_order([n for n, _ in sym._outputs])
    for node in nodes:
        if node.is_variable:
            if node.name in known:
                shape = known[node.name]
            elif "__shape__" in node.attrs:
                shape = node.attrs["__shape__"]
            else:
                continue
            shapes[(id(node), 0)] = tuple(int(x) for x in shape)

    progress = True
    while progress:
        progress = False
        for node in nodes:
            if node.is_variable:
                continue
            if all((id(c), oi) in shapes for c, oi in node.inputs):
                if (id(node), 0) in shapes:
                    continue
                in_shapes = [shapes[(id(c), oi)] for c, oi in node.inputs]
                for i, s in enumerate(_eval_node_shapes(node, in_shapes)):
                    shapes[(id(node), i)] = s
                progress = True
            else:
                rule = _PARAM_SHAPE_RULES.get(node.op)
                if rule is not None and rule(node, shapes):
                    progress = True
    return shapes


def _op_attrs(node, train):
    """The keyword arguments a node's op is called with: its attrs less the
    reserved ``__*__`` ones, and the train flag of a train/predict op."""
    attrs = {k: v for k, v in node.attrs.items() if not k.startswith("__")}
    if _reg.get_op(node.op).needs_mode:
        attrs["_train"] = train
    return attrs


def _eval_node_shapes(node, in_shapes):
    """A node's output shapes, from a run of its op on ``meta`` tensors."""
    from ..ndarray.register import _op_attr_params

    attrs = _op_attrs(node, False)
    if _op_attr_params(_reg.get_op(node.op))[2]:  # a creation op
        attrs["device"] = "meta"
    specs = node_inputs(node, [(s, "float32") for s in in_shapes])
    outs = _reg.infer(node.op, *specs, **attrs)
    return [shape for shape, _ in outs]


def node_inputs(node, ins):
    """A node's inputs in its op's positional order: the optional tensor
    inputs it was given (``__opt_in__``) in their slots, None in the
    others up to the last given."""
    opt_in = node.attrs.get("__opt_in__")
    if not opt_in:
        return list(ins)
    given = opt_in.split(",")
    n_pos = len(ins) - len(given)
    by_slot = dict(zip(given, ins[n_pos:]))
    slots = _reg.get_op(node.op).tensor_opts
    last = max(slots.index(g) for g in given)
    return list(ins[:n_pos]) + [by_slot.get(slot)
                                for slot in slots[:last + 1]]


def _rule(shape_fns):
    """A back-fill rule from ``shape_fns(node, data_shape)`` ->
    {input_index: shape}."""

    def apply(node, shapes):
        data = node.inputs[0]
        if (id(data[0]), data[1]) not in shapes:
            return False
        data_shape = shapes[(id(data[0]), data[1])]
        filled = False
        for idx, shape in shape_fns(node, data_shape).items():
            if idx >= len(node.inputs):
                continue
            child, oi = node.inputs[idx]
            if child.is_variable and (id(child), oi) not in shapes:
                shapes[(id(child), oi)] = tuple(int(x) for x in shape)
                filled = True
        return filled

    return apply


def _fc_rule(node, dsh):
    nh = int(node.attrs.get("num_hidden"))
    flatten = node.attrs.get("flatten", True)
    in_dim = int(_np.prod(dsh[1:])) if flatten in (True, "True", 1) \
        else int(dsh[-1])
    return {1: (nh, in_dim), 2: (nh,)}


def _conv_rule(node, dsh):
    kernel = _as_shape(node.attrs.get("kernel"))
    nf = int(node.attrs.get("num_filter"))
    ng = int(node.attrs.get("num_group", 1))
    return {1: (nf, dsh[1] // ng) + kernel, 2: (nf,)}


def _deconv_rule(node, dsh):
    kernel = _as_shape(node.attrs.get("kernel"))
    nf = int(node.attrs.get("num_filter"))
    ng = int(node.attrs.get("num_group", 1))
    return {1: (dsh[1], nf // ng) + kernel, 2: (nf,)}


def _bn_rule(node, dsh):
    axis = int(node.attrs.get("axis", 1))
    c = dsh[axis % len(dsh)]
    return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}


def _ln_rule(node, dsh):
    axis = int(node.attrs.get("axis", -1))
    c = dsh[axis % len(dsh)]
    return {1: (c,), 2: (c,)}


def _in_rule(node, dsh):
    return {1: (dsh[1],), 2: (dsh[1],)}


def _embed_rule(node, dsh):
    return {1: (int(node.attrs["input_dim"]), int(node.attrs["output_dim"]))}


def _fused_conv_rule(node, dsh):
    per = {1: _conv_rule(node, dsh)[1]}
    nf = int(node.attrs.get("num_filter"))
    for i in range(2, 7):  # bias, gamma, beta, moving_mean, moving_var
        per[i] = (nf,)
    return per


def _prelu_rule(node, dsh):
    if node.attrs.get("act_type", "leaky") == "prelu":
        return {1: (dsh[1] if len(dsh) > 1 else 1,)}
    return {}


def _as_shape(v):
    if v is None:
        return ()
    if isinstance(v, (int, float)):
        return (int(v),)
    return tuple(int(x) for x in v)


_PARAM_SHAPE_RULES = {
    "FullyConnected": _rule(_fc_rule),
    "Convolution": _rule(_conv_rule),
    "Deconvolution": _rule(_deconv_rule),
    "BatchNorm": _rule(_bn_rule),
    "BatchNorm_v1": _rule(_bn_rule),
    "_contrib_SyncBatchNorm": _rule(_bn_rule),
    "LayerNorm": _rule(_ln_rule),
    "InstanceNorm": _rule(_in_rule),
    "Embedding": _rule(_embed_rule),
    "LeakyReLU": _rule(_prelu_rule),
    "_fused_conv_bn_relu": _rule(_fused_conv_rule),
}


def _binary(lhs, rhs, broadcast_op, scalar_op):
    if isinstance(rhs, Symbol):
        if broadcast_op is None:
            raise MXNetError("unsupported symbol-symbol operation")
        return _apply_op(broadcast_op, lhs, rhs)
    if isinstance(rhs, (int, float, bool, _np.number)):
        return _apply_op(scalar_op, lhs, scalar=float(rhs))
    raise TypeError(f"unsupported operand type {type(rhs)}")
