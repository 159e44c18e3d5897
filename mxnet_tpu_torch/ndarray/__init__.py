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

from . import sparse  # noqa: E402  (after the namespaces exist)


# Storage-aware frontends shadow the generated dense renderings (parity
# `mxnet_tpu/ndarray/__init__.py:16-40`): the registered ops stay for
# symbolic graphs, while the imperative API returns the sparse types, as
# the reference does.
def cast_storage(arr, stype="default", **kw):
    """``arr`` in storage type ``stype``: a dense cast stays on the op path
    (recorded by autograd); a storage conversion builds the sparse type."""
    if stype == "default" and not isinstance(arr, sparse.BaseSparseNDArray):
        return invoke_nd("cast_storage", arr, stype=stype, **kw)
    if kw:
        from ..base import MXNetError

        raise MXNetError(
            f"cast_storage to {stype!r}: keyword(s) {sorted(kw)} are not "
            "supported on the sparse path (out= cannot target a different "
            "storage type)")
    return sparse.cast_storage(arr, stype)


def sparse_retain(arr, indices, **kw):
    """The rows of ``arr`` at ``indices``: on a row_sparse array its
    components only, else the dense op."""
    if isinstance(arr, sparse.RowSparseNDArray):
        return sparse.retain(arr, indices)
    return invoke_nd("sparse_retain", arr, indices, **kw)


# the control-flow frontends sit on nd.contrib beside the generated ops
# (reference python/mxnet/ndarray/contrib.py foreach/while_loop/cond)
from . import control_flow as _control_flow  # noqa: E402

contrib.foreach = _control_flow.foreach  # noqa: F821
contrib.while_loop = _control_flow.while_loop  # noqa: F821
contrib.cond = _control_flow.cond  # noqa: F821
