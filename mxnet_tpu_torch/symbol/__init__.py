"""mx.sym: declarative graphs over the port's op registry (parity
`mxnet_tpu/symbol/__init__.py`). The op functions are generated from the
same registry that makes `mx.nd`'s (one function for each op name), so
the symbolic and imperative paths cannot drift. The subgraph framework
(`subgraph`) and its ``TPU_FUSE`` backend (`fusion`) rewrite graphs."""
from .. import ndarray as _nd  # noqa: F401  (registers every op)
from ..ndarray.register import populate_op_namespaces as _populate
from ..ops import registry as _reg
from .executor import Executor
from .symbol import (Group, Symbol, Variable, _apply_op, load, load_json,
                     var)
from .subgraph import (SubgraphProperty, SubgraphSelector, build_subgraph,
                       get_subgraph_property, list_subgraph_backends,
                       register_subgraph_property)
from . import fusion as _fusion  # noqa: F401  (registers TPU_FUSE)

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "Executor", "zeros", "ones", "SubgraphSelector",
           "SubgraphProperty", "register_subgraph_property",
           "get_subgraph_property", "list_subgraph_backends",
           "build_subgraph"]


def _make_sym_func(op_name, func_name):
    def fn(*args, **kwargs):
        return _apply_op(op_name, *args, **kwargs)

    fn.__name__ = func_name
    fn.__doc__ = _reg.get_op(op_name).doc or f"Symbolic op `{op_name}`."
    return fn


_populate(root_module_name=__name__, make_func=_make_sym_func,
          tensor_type=Symbol)


def zeros(shape, dtype="float32", **kwargs):
    return _apply_op("_zeros", shape=shape, dtype=dtype, **kwargs)


def ones(shape, dtype="float32", **kwargs):
    return _apply_op("_ones", shape=shape, dtype=dtype, **kwargs)


# the control-flow frontends sit on sym.contrib beside the generated ops
from . import control_flow as _control_flow  # noqa: E402

contrib.foreach = _control_flow.foreach  # noqa: F821
contrib.while_loop = _control_flow.while_loop  # noqa: F821
contrib.cond = _control_flow.cond  # noqa: F821
