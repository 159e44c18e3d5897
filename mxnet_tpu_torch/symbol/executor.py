"""The symbolic executor: a Symbol bound to arrays. The port of
`mxnet_tpu/symbol/executor.py` (parity `src/executor/graph_executor.cc`
and `python/mxnet/executor.py`).

The whole graph is one function of tensors (`_graph_fn`), built once from
the Symbol over the op registry and run eagerly by `forward`; `backward`
takes torch's gradient of the outputs of the last training forward. The
training step (`fused_step`: the forward, the gradient with ones
cotangents, the optimizer's fused update and the BatchNorm moving stats)
is one function too. On a CUDA card it is captured as ONE CUDA graph for
each signature (shapes and dtypes of the arguments, aux states and
optimizer states, and the optimizer's static key) and replayed at every
later step: one host launch where the JAX package runs one jitted XLA
program (`executor.py:336`). On the CPU it runs eagerly.

An inference forward (``forward(is_train=False)`` of an executor whose
every ``grad_req`` is ``"null"``, as `Module.bind(for_training=False)` and
the serving `Predictor` bind it) is built once for each signature through
the executor's ``_cache``: on a card one CUDA graph over the bound argument
and aux tensors, replayed at every later forward, where the JAX package
jits one XLA program (`executor.py:223`); on the CPU the eager function.

The arrays stay where they are: `set_args` copies a batch into the bound
tensors, the fused update writes the weights, momenta and moving stats in
place, and an array rebound to another tensor since a capture is copied
into the captured tensor before the replay and bound to it again.

Observability: the weights (arguments with a gradient) and the gradient
buffers are live views of the memory census; with the observatory on,
each program's first eager run is counted (`compile_cache.measure_cost`)
and `fused_step` observes the ``step`` lane with CUDA events around its
replay (JAX `executor.py:587-616`, which drained the step instead: here
nothing waits on the card), inside a ``fused.dispatch`` span.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import memory, observatory, tracing
from .. import random as _random
from ..base import MXNetError
from ..compile_cache import WARMUP_CALLS, CompileCache, capture, measure_cost
from ..context import Context, current_context
from ..ndarray.register import _op_attr_params
from ..ops import registry as _reg
from ..optimizer.optimizer import fused_hyper_args
from .symbol import _op_attrs, _topo_order, node_inputs

__all__ = ["Executor"]


def _dispatch_node(node, env, train, device):
    """Evaluate ONE op node into ``env``: its attrs less the reserved ones,
    the train flag, the generator of an op that draws random numbers (the
    port's generator of ``device``: replays of a captured step draw anew),
    the outputs unpacked."""
    op = _reg.get_op(node.op)
    attrs = _op_attrs(node, train)
    if _op_attr_params(op)[2]:  # a creation op: made on the graph's device
        attrs["device"] = device
    ins = node_inputs(node, [env[(id(c), oi)] for c, oi in node.inputs])
    if op.needs_rng:
        ins.insert(0, _random.generator(device))
    out = _reg.invoke(node.op, *ins, **attrs)
    for i, o in enumerate(out if isinstance(out, (tuple, list)) else (out,)):
        env[(id(node), i)] = o


def _graph_fn(sym, arg_names, aux_names, train):
    """The function of a Symbol graph: ``fn(args, auxs) -> (outputs,
    aux_updates)``, tuples of tensors in the order of the names."""
    nodes = _topo_order([n for n, _ in sym._outputs])
    arg_pos = {n: i for i, n in enumerate(arg_names)}
    aux_pos = {n: i for i, n in enumerate(aux_names)}

    # aux write-back map: aux variable id -> (producer node, output index)
    aux_writer = {}
    for node in nodes:
        if node.is_variable:
            continue
        maux = node.aux_input_indices()
        n_user = node.num_outputs() - len(maux)
        for j, in_idx in enumerate(maux):
            if in_idx < len(node.inputs):
                child, _ = node.inputs[in_idx]
                if child.is_variable:
                    aux_writer[id(child)] = (node, n_user + j)

    def fn(args, auxs):
        env = {}
        device = next(iter(args or auxs)).device
        for node in nodes:
            if not node.is_variable:
                continue
            if node.name in arg_pos:
                env[(id(node), 0)] = args[arg_pos[node.name]]
            elif node.name in aux_pos:
                env[(id(node), 0)] = auxs[aux_pos[node.name]]
            else:
                raise MXNetError(f"variable {node.name} is not bound")
        for node in nodes:
            if not node.is_variable:
                _dispatch_node(node, env, train, device)
        outputs = tuple(env[(id(n), oi)] for n, oi in sym._outputs)
        aux_new = []
        for node in nodes:
            if node.is_variable and node.name in aux_pos:
                w = aux_writer.get(id(node))
                key = (id(w[0]), w[1]) if w is not None else None
                aux_new.append(env[key] if key in env
                               else env[(id(node), 0)])
        return outputs, tuple(aux_new)

    return fn


def _as_tensor(v, device):
    from ..ndarray import NDArray

    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(_np.asarray(v), device=device)


class Executor:
    """A bound Symbol (reference `Executor::Forward/Backward`), on the
    device of ``ctx`` (default: the current context, ``gpu(0)`` unless a
    ``with mx.cpu():`` says otherwise; without a card that raises)."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        from ..ndarray import zeros

        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else current_context()
        self._device = self._ctx.torch_device
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()

        self.arg_dict = self._normalize(args, self._arg_names, "args")
        self.aux_dict = self._normalize(aux_states, self._aux_names,
                                        "aux_states", allow_missing=True)

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self._arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self._arg_names}

        self.grad_dict = {} if args_grad is None else self._normalize(
            args_grad, self._arg_names, "args_grad", allow_missing=True)
        for n in self._arg_names:
            if self._grad_req.get(n, "null") != "null" \
                    and n not in self.grad_dict:
                a = self.arg_dict[n]
                self.grad_dict[n] = zeros(a.shape, ctx=self._ctx,
                                          dtype=a.dtype)

        self.outputs = []
        self._vjp = None
        self._monitor_callback = None
        self._fns = {}
        # the training steps and the inference forwards, one for each
        # signature (captured graphs on a card): a miss after warm-up is a
        # capture the run did not expect. A serving Predictor points
        # ``_cache`` at its own "serving" cache, and ``_graph_pool`` (the
        # memory pool of the inference graphs; None: a private one each)
        # at one pool for all its buckets
        self._steps = CompileCache("executor")
        self._cache = CompileCache("executor")
        self._graph_pool = None
        self._last_fwd_key = None
        # the memory census's live views (a rebind replaces ``_data``)
        memory.register_provider(
            "weights", self,
            lambda s: [a for n, a in s.arg_dict.items()
                       if s._grad_req.get(n, "null") != "null"])
        memory.register_provider("gradients", self,
                                 lambda s: list(s.grad_dict.values()))

    # -- helpers -------------------------------------------------------------

    def _normalize(self, values, names, what, allow_missing=False):
        from ..ndarray import NDArray, array as nd_array

        out = {}
        if values is None:
            values = {}
        if isinstance(values, (list, tuple)):
            if len(values) != len(names):
                raise MXNetError(f"{what}: expected {len(names)} entries "
                                 f"({names}), got {len(values)}")
            values = dict(zip(names, values))
        for n in names:
            v = values.get(n)
            if v is None:
                if allow_missing:
                    continue
                raise MXNetError(f"{what}: missing value for {n}")
            out[n] = v.as_in_context(self._ctx) if isinstance(v, NDArray) \
                else nd_array(v, ctx=self._ctx)
        return out

    def _fn(self, train):
        fn = self._fns.get(train)
        if fn is None:
            fn = self._fns[train] = _graph_fn(self._symbol, self._arg_names,
                                              self._aux_names, train)
        return fn

    # -- API -----------------------------------------------------------------

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    @torch.no_grad()
    def set_args(self, **kwargs):
        """Write input values into the bound argument tensors, in place
        (the feed of ``forward`` and of the fused step); a value of another
        shape rebinds its argument."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown argument {k}")
            tgt = self.arg_dict[k]
            src = _as_tensor(v, self._device)
            if tuple(src.shape) == tgt.shape:
                tgt._data.copy_(src)
            else:
                tgt._data = src.detach().to(self._device, tgt._data.dtype)

    def forward(self, is_train=False, **kwargs):
        from ..ndarray import NDArray

        self._vjp = None  # the last forward's graph can go
        self.set_args(**kwargs)
        train = bool(is_train)
        if not train and all(r == "null" for r in self._grad_req.values()):
            sig = tuple((n, a.shape, a._data.dtype) for n, a in
                        (*self.arg_dict.items(), *self.aux_dict.items()))
            # the executor is part of the key: a shared cache's program
            # replays over the tensors of the executor that built it
            self._last_fwd_key = ("fwd", self, sig)
            fwd = self._cache.get_or_build(self._last_fwd_key,
                                           lambda: _Inference(self))
            self.outputs = [NDArray(o) for o in fwd()]
            self._monitor(self.outputs)
            return self.outputs
        diff = [n for n in self._arg_names
                if self._grad_req.get(n, "null") != "null"] if train else []
        leaves = {n: self.arg_dict[n]._data.detach().requires_grad_()
                  for n in diff}
        args = tuple(leaves.get(n, self.arg_dict[n]._data)
                     for n in self._arg_names)
        auxs = tuple(self.aux_dict[n]._data for n in self._aux_names)
        with torch.set_grad_enabled(bool(diff)):
            outputs, aux_new = self._fn(train)(args, auxs)
        if train:
            # aux write-back (moving stats), in place
            with torch.no_grad():
                for n, a in zip(self._aux_names, aux_new):
                    if a is not self.aux_dict[n]._data:
                        self.aux_dict[n]._data.copy_(a)
        if diff:
            self._vjp = (outputs, diff, [leaves[n] for n in diff])
        self.outputs = [NDArray(o.detach()) for o in outputs]
        self._monitor(self.outputs)
        return self.outputs

    def _monitor(self, outputs):
        if self._monitor_callback is not None:
            for name, out in zip(self._symbol.list_outputs(), outputs):
                self._monitor_callback(name, out)

    def backward(self, out_grads=None, is_train=True):
        """The gradients of the last training forward's outputs (ones by
        default) into ``grad_dict``, written (``write``) or added
        (``add``) in place."""
        from ..ndarray import NDArray

        if self._vjp is None:
            raise MXNetError("backward requires forward(is_train=True) first "
                             "(and at least one grad_req != 'null')")
        outputs, names, leaves = self._vjp
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outputs]
        else:
            if isinstance(out_grads, (NDArray, _np.ndarray, torch.Tensor)):
                out_grads = [out_grads]
            cts = [_as_tensor(g, self._device) for g in out_grads]
        pairs = [(o, c) for o, c in zip(outputs, cts) if o.requires_grad]
        grads = [None] * len(leaves)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], leaves, [c for _, c in pairs],
                retain_graph=True, allow_unused=True)
        with torch.no_grad():
            for n, g, leaf in zip(names, grads, leaves):
                req = self._grad_req[n]
                tgt = self.grad_dict[n]._data
                if g is None:
                    g = torch.zeros_like(leaf)
                if req == "write":
                    tgt.copy_(g)
                elif req == "add":
                    tgt.add_(g.to(tgt.dtype))

    def fused_step(self, optimizer, updater, param_names, grad_sync_fn=None,
                   grad_sync_key=None, zero1=None, pipeline=None, spmd=None):
        """ONE training step: the forward, the gradients of the outputs
        with ones cotangents (the ``backward(out_grads=None)`` convention)
        for the parameters whose ``grad_req`` is ``write``, the
        optimizer's fused update of them in place, and the moving stats.
        On a card, one captured CUDA graph replayed per step; the eager
        ``forward`` + ``backward`` + update stays the correctness
        reference.

        ``param_names`` is the module's parameter list: updater states are
        keyed by position in it, as the eager ``Module.update`` keys them.
        The learning rates, weight decays and ``rescale_grad`` reach the
        graph as a device tensor written before each replay, so a
        scheduler's rate is the one applied. Gradients are consumed inside
        the step: ``grad_dict`` is NOT written by this path. Returns the
        outputs (copies; also in ``self.outputs``).

        ``grad_sync_fn``, ``zero1``, ``pipeline`` and ``spmd`` (the JAX
        package's in-program gradient sync, ZeRO-1, pipeline and SPMD
        steps) are not ported yet and raise NotImplementedError."""
        from ..ndarray import NDArray
        from ..optimizer.optimizer import (_restore_counts,
                                           _snapshot_counts,
                                           fused_hyper_slots)

        for what, value in (("grad_sync_fn", grad_sync_fn),
                            ("zero1", zero1), ("pipeline", pipeline),
                            ("spmd", spmd)):
            if value is not None:
                raise NotImplementedError(
                    f"Executor.fused_step({what}=...) is not ported yet "
                    "(ROADMAP.md queue A, item A.7)")
        upd = [(i, n) for i, n in enumerate(param_names)
               if self._grad_req.get(n, "null") != "null"]
        indices = [i for i, _ in upd]
        names = [n for _, n in upd]
        updater.ensure_states(indices, [self.arg_dict[n] for n in names])
        counts = _snapshot_counts(optimizer, indices)
        optimizer._update_count(indices)
        lrs, wds = optimizer._fused_hyperparams(indices)
        # the weights that share (lr, wd) share a slot of the hyperparameter
        # tensor; the partition is part of the signature, the values not
        groups, hyper = fused_hyper_slots(lrs, wds)
        hyper.append(optimizer.rescale_grad)
        bound = _Bound(self, updater, indices, names)
        sig = (tuple(names), bound.signature(),
               optimizer._fused_static_key(), groups)
        key = ("fused_step", sig)
        events = None
        try:
            step = self._steps.get_or_build(
                key, lambda: _FusedStep(self, optimizer, names, groups,
                                        bound))
            with tracing.span("fused.dispatch", cat="train",
                              params=len(names)):
                if observatory._enabled and step.graph is not None:
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                outputs = step(bound, hyper)
                if events is not None:
                    events[1].record()
        except Exception:
            _restore_counts(optimizer, counts)
            raise
        if observatory._enabled:
            # the program that ran and its device window; the fit loop
            # observes the step's wall
            observatory.observe("step", self._steps, key, events=events)
        self._vjp = None
        self.outputs = [NDArray(o) for o in outputs]
        return self.outputs

    @torch.no_grad()
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays, in place."""
        for table, values, what in ((self.arg_dict, arg_params, "arg"),
                                    (self.aux_dict, aux_params, "aux")):
            for k, v in (values or {}).items():
                if k in table:
                    table[k]._data.copy_(_as_tensor(v, self._device))
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} {k}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes, sharing every array whose
        shape stays."""
        from ..ndarray import zeros

        arg_shapes, _, aux_shapes = self._symbol.infer_shape_partial(**{
            k: v for k, v in kwargs.items() if k in self._arg_names})

        def resized(table, names, shapes):
            out = {}
            for n, s in zip(names, shapes):
                cur = table[n]
                out[n] = zeros(s, ctx=self._ctx, dtype=cur.dtype) \
                    if s is not None and cur.shape != tuple(s) else cur
            return out

        new = Executor(self._symbol, self._ctx,
                       args=resized(self.arg_dict, self._arg_names,
                                    arg_shapes),
                       grad_req=self._grad_req,
                       aux_states=resized(self.aux_dict, self._aux_names,
                                          aux_shapes))
        # an installed monitor survives (it also gates the fused step)
        new._monitor_callback = self._monitor_callback
        return new

    def set_monitor_callback(self, callback, monitor_all=False):
        """Install a per-output monitor (reference
        `MXExecutorSetMonitorCallbackEX`)."""
        self._monitor_callback = callback

    def debug_str(self):
        return self._symbol.debug_str()


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _leaves(s)]


def _rebuild(state, leaves):
    """``state``'s tree with its tensors taken from ``leaves`` in order."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return next(leaves)
    return type(state)(_rebuild(s, leaves) for s in state)


class _Bound:
    """The tensors one fused step reads and writes: the parameters, the
    other arguments (data, labels), the aux states and the optimizer
    states, where they lie now."""

    def __init__(self, ex, updater, indices, names):
        name_set = set(names)
        self.ex, self.updater, self.indices = ex, updater, indices
        self.arrays = ([ex.arg_dict[n] for n in names],
                       [ex.arg_dict[n] for n in ex._arg_names
                        if n not in name_set],
                       [ex.aux_dict[n] for n in ex._aux_names])
        self.states = [updater.states[i] for i in indices]

    def tensors(self):
        params, others, auxs = ([a._data for a in group]
                                for group in self.arrays)
        return params, others, auxs, self.states

    def signature(self):
        def sig(ts):
            return tuple((tuple(t.shape), t.dtype) for t in ts)

        params, others, auxs, states = self.tensors()
        return (sig(params), sig(others), sig(auxs),
                tuple(sig(_leaves(s)) for s in states))

    def bind_to(self, static):
        """Copy every tensor that is not the captured one into it, and bind
        its array (or the updater's state) to the captured one again."""
        def same(a, b):
            return a is b or (a.data_ptr() == b.data_ptr()
                              and a.stride() == b.stride())

        s_arrays, s_states = static
        with torch.no_grad():
            for group, s_group in zip(self.arrays, s_arrays):
                for arr, s in zip(group, s_group):
                    if not same(arr._data, s):
                        s.copy_(arr._data)
                        arr._data = s
            for k, (i, state, s_state) in enumerate(
                    zip(self.indices, self.states, s_states)):
                cur = _leaves(state)
                if any(not same(a, b) for a, b in zip(cur, s_state)):
                    for a, b in zip(cur, s_state):
                        if not same(a, b):
                            b.copy_(a)
                    self.states[k] = self.updater.states[i] = _rebuild(
                        state, iter(s_state))


class _FusedStep:
    """One signature's training step: the eager function on the CPU; on a
    card, that function captured as one CUDA graph after `WARMUP_CALLS`
    eager runs on a side stream whose writes are then undone, so the first
    call applies exactly one update."""

    def __init__(self, ex, optimizer, names, groups, bound):
        base = ex._fn(True)
        arg_pos = {n: i for i, n in enumerate(ex._arg_names)}
        name_set = set(names)
        param_pos = [arg_pos[n] for n in names]
        other_pos = [arg_pos[n] for n in ex._arg_names if n not in name_set]
        n_args, n_groups = len(ex._arg_names), max(groups, default=-1) + 1

        def step(params, others, auxs, states, hyper):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in params]
                full = [None] * n_args
                for t, i in zip(leaves, param_pos):
                    full[i] = t
                for t, i in zip(others, other_pos):
                    full[i] = t
                outputs, aux_new = base(tuple(full), tuple(auxs))
                diff = [o for o in outputs if o.requires_grad]
                grads = torch.autograd.grad(
                    diff, leaves, [torch.ones_like(o) for o in diff],
                    allow_unused=True) if diff and leaves \
                    else [None] * len(leaves)
            with torch.no_grad():
                grads = [torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, params)]
                optimizer.fused_update(
                    list(params), grads, list(states),
                    *fused_hyper_args(hyper, groups), groups=groups)
                for a, new in zip(auxs, aux_new):
                    if new is not a:
                        a.copy_(new)
            return tuple(o.detach() for o in outputs)

        self.step = step
        self.n_hyper = 2 * n_groups + 1
        self.device = ex._device
        self.graph = None
        self.captures = 0
        self.cost = None
        if self.device.type == "cuda":
            self._capture(bound)

    def _run_counted(self, bound, hyper_t):
        """One eager step, counted into ``cost`` when it is the first with
        the observatory on: every bound tensor is read once."""
        params, others, auxs, states = bound.tensors()

        def run():
            return self.step(params, others, auxs, states, hyper_t)

        if self.cost is None and observatory._enabled:
            out, self.cost = measure_cost(
                run, [*params, *others, *auxs,
                      *(t for s in states for t in _leaves(s))])
            return out
        return run()

    def _capture(self, bound):
        params, others, auxs, states = bound.tensors()
        self.static = (tuple(list(g) for g in (params, others, auxs)),
                       [_leaves(s) for s in states])
        self.hyper = torch.zeros(self.n_hyper, dtype=torch.float32,
                                 device=self.device)
        written = list(params) + list(auxs) + \
            [t for s in states for t in _leaves(s)]

        def run():
            return self.step(params, others, auxs, states, self.hyper)

        def warm_up():
            saved = [t.detach().clone() for t in written]
            try:
                for _ in range(WARMUP_CALLS):
                    self._run_counted(bound, self.hyper)
            finally:
                with torch.no_grad():
                    for t, s in zip(written, saved):
                        t.copy_(s)

        self.graph, self.outputs = capture(
            run, self.device, generator=_random.generator(self.device),
            warm_up=warm_up, owner=self)
        self.captures += 1

    def __call__(self, bound, hyper):
        if self.graph is None:
            return self._run_counted(bound, torch.tensor(
                hyper, dtype=torch.float32, device=self.device))
        bound.bind_to(self.static)
        self.hyper.copy_(torch.tensor(hyper, dtype=torch.float32)
                         .pin_memory(), non_blocking=True)
        self.graph.replay()
        return [o.clone() for o in self.outputs]


class _Inference:
    """One signature's inference forward: the eager graph function on the
    CPU; on a card, that function captured as ONE CUDA graph over the bound
    argument and aux tensors after `WARMUP_CALLS` eager runs on a side
    stream (it writes nothing, so nothing is undone), in the memory pool
    ``ex._graph_pool``. A replay reads the
    bound tensors where they lie: `set_args` and `Predictor.swap_weights`
    write into them, and an array rebound since the capture is copied into
    the captured tensor first and bound to it again. Each call returns
    copies of the outputs, enqueued right after the replay, so the next
    replay cannot overwrite what a caller holds. A capture that fails
    raises; nothing falls back to eager calls."""

    def __init__(self, ex):
        fn = ex._fn(False)
        self.arrays = ([ex.arg_dict[n] for n in ex._arg_names],
                       [ex.aux_dict[n] for n in ex._aux_names])
        self.static = tuple([a._data for a in g] for g in self.arrays)
        self.device = ex._device
        self.pool = ex._graph_pool
        self.run = lambda: fn(*self.static)[0]
        self.graph = None
        self.captures = 0
        self.cost = None
        if self.device.type == "cuda":
            self._capture()

    def _run_counted(self):
        """One eager forward, counted into ``cost`` when it is the first
        with the observatory on: the bound tensors read once."""
        if self.cost is None and observatory._enabled:
            out, self.cost = measure_cost(
                self.run, [t for g in self.static for t in g])
            return out
        return self.run()

    def _capture(self):
        def warm_up():
            for _ in range(WARMUP_CALLS):
                self._run_counted()

        with torch.no_grad():
            self.graph, self.outputs = capture(
                self.run, self.device, self.pool,
                _random.generator(self.device), warm_up=warm_up, owner=self)
        self.captures += 1

    def __call__(self):
        with torch.no_grad():
            if self.graph is None:
                return list(self._run_counted())
            for group, s_group in zip(self.arrays, self.static):
                for arr, s in zip(group, s_group):
                    if arr._data is not s:
                        s.copy_(arr._data)
                        arr._data = s
            self.graph.replay()
            return [o.clone() for o in self.outputs]
