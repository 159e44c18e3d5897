"""mx.nd: the NDArray package with its generated op namespace (parity
`mxnet_tpu/ndarray/__init__.py`)."""
from .. import ops as _ops  # noqa: F401  (registers every op)
from .ndarray import (
    NDArray, array, zeros, ones, full, empty, arange, concatenate, waitall,
    moveaxis, onehot_encode, maximum, minimum, power, hypot, add, subtract,
    multiply, divide, modulo, equal, not_equal, greater, greater_equal,
    lesser, lesser_equal, true_divide,
)
from .register import invoke_nd, populate_op_namespaces
from .utils import save, load  # noqa: F401

populate_op_namespaces(__name__)

# the control-flow frontends sit on nd.contrib beside the generated ops
# (reference python/mxnet/ndarray/contrib.py foreach/while_loop/cond)
from . import control_flow as _control_flow  # noqa: E402

contrib.foreach = _control_flow.foreach  # noqa: F821
contrib.while_loop = _control_flow.while_loop  # noqa: F821
contrib.cond = _control_flow.cond  # noqa: F821
