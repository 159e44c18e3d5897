"""Autograd with MXNet semantics, on torch's autograd engine: the port of
`mxnet_tpu/autograd.py`.

Inside `record()` ops run with grad enabled, so torch builds the graph;
outside it they run under ``no_grad`` and build none. `attach_grad` makes an
NDArray's tensor a leaf that requires grad. Each marked NDArray that a
recorded op reads is noted with the tensor it held then. `backward` takes
the gradients of the heads with `torch.autograd.grad` over those leaf
tensors and deposits each into its NDArray's ``grad`` by ``grad_req``
(``write``, ``add`` or ``null``): torch's own ``.grad`` accumulation never
happens. A leaf that no head depends on keeps its ``grad`` as it was, as
in the JAX package, whose tape never reaches it.

A write to a marked NDArray while recording rebinds it to a new tensor,
and its gradient stays that of the value recording first saw, as in the
JAX package (`_recorded_setitem`).

Row-sparse gradients (the JAX package's `_RowSparseCT`): an op that elects
one (Embedding with ``sparse_grad``) hands torch's engine a sparse COO
gradient, the (indices, rows) of the touched rows. Along the graph two of
them add by concatenation, duplicates unmerged, and one meeting a dense
gradient becomes dense, as in the JAX package. `_deposit` writes a sparse
gradient into a row_sparse ``grad`` buffer as its components, deduplicated
(sorted unique rows, summed), merging the old rows under ``add``: no dense
intermediate. Into a dense buffer it is densified. Inside a hybridized
block's function (`CachedOp`) and in `grad`, gradients are dense.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

import torch

from .base import MXNetError

__all__ = [
    "record", "pause", "train_mode", "predict_mode", "is_recording",
    "is_training", "set_recording", "set_training", "mark_variables",
    "backward", "grad", "Function", "get_symbol",
]

_state = threading.local()
# False while a hybridized block's function runs: ops give dense gradients
_SPARSE_GRADS = contextvars.ContextVar("mxnet_tpu_torch_sparse_grads",
                                       default=True)


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.scope_depth = 0
        # id(NDArray) -> (NDArray, the leaf tensor a recorded op read)
        _state.leaves = {}
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    return prev


def set_training(train_mode):
    st = _st()
    prev, st.training = st.training, bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
            if self._enter_is_record:
                st = _st()
                st.scope_depth += 1
                # a fresh outermost record scope forgets the leaves of one
                # that was never backward()ed; a record nested in pause()
                # keeps the outer scope's
                if st.scope_depth == 1 and not self._prev_is_record:
                    st.leaves = {}
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, ptype, value, trace):
        if self._enter_is_record is not None:
            if self._enter_is_record:
                st = _st()
                st.scope_depth = max(0, st.scope_depth - 1)
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Scope: ops executed inside are recorded for `backward`."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _note_input(nd):
    """Called by the frontend for each NDArray a recorded op reads."""
    if nd._ag_marked and nd._data.requires_grad:
        _st().leaves.setdefault(id(nd), (nd, nd._data))


def _make_leaf(nd):
    """Rebind a marked NDArray to a leaf tensor that requires grad."""
    nd._data = nd._data.detach().requires_grad_(
        nd.grad_req != "null" and nd._data.is_floating_point())


def mark_variables(variables, gradients, grad_reqs="write"):
    """Associate gradient buffers with arrays (parity `autograd.py:216`)."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.grad = g
        v.grad_req = req
        v._ag_marked = True
        _make_leaf(v)


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    tensors, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue  # no marked variable reaches it: it adds nothing
        tensors.append(h._data)
        if hg is None:
            grads.append(torch.ones_like(h._data))
        else:
            hg = hg._data if isinstance(hg, NDArray) else torch.as_tensor(hg)
            grads.append(hg.to(h._data.device, h._data.dtype))
    if not tensors:
        raise MXNetError(
            "cannot differentiate heads that were not recorded from a "
            "marked variable (call attach_grad and compute them inside "
            "autograd.record())")
    return tensors, grads


def sparse_grads_allowed():
    """Whether a recorded op may give a row-sparse gradient here."""
    return _SPARSE_GRADS.get()


@contextlib.contextmanager
def _dense_grads():
    """Ops inside give dense gradients (a hybridized block's function)."""
    token = _SPARSE_GRADS.set(False)
    try:
        yield
    finally:
        _SPARSE_GRADS.reset(token)


def dedup_rows(indices, rows):
    """The canonical row_sparse form of (indices, rows) that may repeat an
    index: sorted unique indices and the sum of each one's rows."""
    uniq, inv = torch.unique(indices, sorted=True, return_inverse=True)
    summed = rows.new_zeros((uniq.shape[0],) + tuple(rows.shape[1:]))
    summed.index_add_(0, inv.reshape(-1), rows)
    return uniq, summed


def _deposit(nd, g):
    if nd.grad is None or nd.grad_req == "null":
        return
    from .ndarray.sparse import RowSparseNDArray

    buf = nd.grad
    if g.is_sparse and isinstance(buf, RowSparseNDArray):
        idx, rows = g._indices()[0], g._values().detach()
        if nd.grad_req == "add":
            old = buf._components()
            idx = torch.cat([old["indices"].to(idx.dtype), idx])
            rows = torch.cat([old["data"], rows.to(old["data"].dtype)])
        uniq, summed = dedup_rows(idx, rows)
        buf._set_components(data=summed.to(buf._dtype_meta),
                             indices=uniq.to(torch.int32))
        nd._fresh_grad = True
        return
    if g.is_sparse:
        g = g.to_dense()
    g = g.detach().to(buf._data.dtype)
    if nd.grad_req == "add":
        g = buf._data + g
    buf._data = g
    nd._fresh_grad = True


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Compute the gradients of ``heads`` with respect to every marked
    variable they were recorded from (parity `autograd.py:243`)."""
    from .ndarray.ndarray import NDArray

    tensors, grads = _heads(heads, head_grads)
    st = _st()
    # a head that is a marked variable itself (an identity block's output)
    # takes its own cotangent, as the JAX package deposits into heads
    for h in [heads] if isinstance(heads, NDArray) else heads:
        _note_input(h)
    leaves = list(st.leaves.values())
    if leaves:
        gs = torch.autograd.grad(tensors, [t for _, t in leaves], grads,
                                 retain_graph=retain_graph, allow_unused=True)
        for (nd, _), g in zip(leaves, gs):
            if g is not None:
                _deposit(nd, g)
    if not retain_graph:
        st.leaves = {}


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Return the gradients of heads with respect to variables without
    touching their ``grad`` buffers (parity `autograd.py:270`). With
    ``create_graph`` the results are recorded too, so a second `backward`
    or `grad` through them gives higher derivatives."""
    from .ndarray.ndarray import NDArray

    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    tensors, grads = _heads(heads, head_grads)
    st = _st()
    inputs = [st.leaves.get(id(v), (v, v._data))[1] for v in variables]
    if not all(t.requires_grad for t in inputs):
        raise MXNetError("grad: every variable must be marked "
                         "(attach_grad) before recording")
    with torch.set_grad_enabled(create_graph):
        gs = torch.autograd.grad(tensors, inputs, grads,
                                 retain_graph=retain_graph,
                                 create_graph=create_graph, allow_unused=True)
    if any(g is None for g in gs):
        raise MXNetError("Cannot differentiate with respect to a variable "
                         "the heads do not depend on")
    gs = [g.to_dense() if g.is_sparse else g for g in gs]
    outs = [NDArray(g if create_graph else g.detach()) for g in gs]
    if not retain_graph:
        st.leaves = {}
    return outs[0] if single else outs


def get_symbol(x):
    """Raises, as the JAX package's does: a recorded graph has no symbol;
    `HybridBlock.export` writes one."""
    raise MXNetError("autograd.get_symbol is not supported; use "
                     "HybridBlock.export")


class _Bridge(torch.autograd.Function):
    """One recorded node for a user `Function`: its forward and backward,
    on NDArrays, run unrecorded."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray

        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        ctx.func = func
        outs = [outs] if isinstance(outs, NDArray) else list(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray

        with pause():
            in_grads = ctx.func.backward(*[NDArray(c) for c in cts])
        if isinstance(in_grads, NDArray):
            in_grads = [in_grads]
        return (None,) + tuple(None if g is None else g._data
                               for g in in_grads)


class Function:
    """Custom differentiable function (parity `autograd.py:365`).

    Subclass and implement ``forward`` and ``backward`` on NDArrays. Under
    `record()` the call is one node of torch's graph whose backward calls
    the user's, unrecorded.
    """

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not is_recording():
            with pause():
                return self.forward(*inputs)
        for x in inputs:
            _note_input(x)
        outs = _Bridge.apply(self, *[x._data for x in inputs])
        outs = [NDArray(t) for t in outs]
        return outs[0] if len(outs) == 1 else outs
