"""Symbol-level control-flow operators over serialized subgraphs: the port
of `mxnet_tpu/ops/control_flow_ops.py` (parity the reference's
`src/operator/control_flow.cc`: `_foreach`:1255, `_while_loop`:1316,
`_cond`:1378).

A subgraph travels as a JSON string attribute (what `Symbol.tojson`
writes, so it survives a save and a load) and runs through the symbolic
executor's graph function (`symbol/executor.py` `_graph_fn`), as the
`_subgraph_exec` region does.

- `_foreach`: a loop over the leading axis of its data, written out at
  the call: the body runs once a step, so a body that draws random numbers
  draws anew at each step from the device's generator (the streams are
  torch's, not threefry's, and cannot be matched bit for bit).
- `_while_loop`: the JAX op's bounded loop: ``max_iterations`` steps, each
  under an ``active`` flag (the condition so far, a device tensor), the
  loop variables frozen and the step outputs zero once it falls. The trip
  count is static and the condition is never read on the host, so a graph
  that holds the loop can be captured.
- `_cond`: both branches run and the outputs are selected by the
  predicate, on the device; the JAX op runs one branch (`lax.cond`).
  Selecting keeps the op capturable (a host read of the predicate is a
  sync, and cannot sit inside a CUDA graph). The inputs of each branch
  pass a gate (`gate`) that lets the gradient through only where that
  branch was taken, so a non-finite value in the branch not taken (a log
  of zero) never reaches a gradient. The loop's body is gated the same
  way by its ``active`` flag.
"""
from __future__ import annotations

import functools
import json

import torch

from .registry import register

__all__ = ["gate", "select"]


class _Gate(torch.autograd.Function):
    """The identity forward; backward passes the gradient where ``keep``
    (a bool tensor) holds and zero elsewhere, selecting, so that a NaN or
    infinity behind the gate is dropped, not multiplied by zero."""

    @staticmethod
    def forward(ctx, keep, x):
        ctx.save_for_backward(keep)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        return None, torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                                      device=g.device))


def gate(keep, x):
    """``x`` behind `_Gate` when a gradient can flow through it."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Gate.apply(keep, x)


def select(pred, a, b):
    """``a`` where the scalar ``pred`` holds, else ``b``."""
    return torch.where(pred, a, b)


def _as_json_str(subgraph):
    # a JSON round trip of the outer symbol may parse the attr into a dict
    return subgraph if isinstance(subgraph, str) else json.dumps(subgraph)


@functools.lru_cache(maxsize=256)
def _graph(subgraph, arg_names, train):
    from ..symbol import symbol as _sym
    from ..symbol.executor import _graph_fn

    return _graph_fn(_sym.load_json(subgraph), _split_csv(arg_names), [],
                     bool(train))


def _sub_fn(subgraph, arg_names, train):
    """The serialized subgraph as ``fn(args) -> outputs`` (a tuple)."""
    inner = _graph(_as_json_str(subgraph), arg_names, bool(train))
    return lambda args: inner(tuple(args), ())[0]


def _split_csv(s):
    return [x for x in (s or "").split(",") if x]


def _free_names(first, second, taken=()):
    """The names of the free inputs, in the node's input order: those of
    ``first`` then of ``second``, each once, less ``taken``."""
    out, seen = [], set(taken)
    for nm in _split_csv(first) + _split_csv(second):
        if nm not in seen:
            seen.add(nm)
            out.append(nm)
    return out


@register("_foreach", needs_rng=True, needs_mode=True,
          num_outputs=lambda attrs: int(attrs["n_out"])
          + int(attrs["n_states"]))
def _foreach(gen, *arrays, subgraph="", sub_args="", n_data=0, n_states=0,
             n_out=0, _train=False):
    """``body(data[t], states, free) -> (outputs, states)`` over the
    leading axis of the data; outputs stacked on a new leading axis, then
    the final states. Each random node of the body draws from its device's
    generator, so ``gen`` goes unused."""
    n_data, n_states, n_out = int(n_data), int(n_states), int(n_out)
    data = arrays[:n_data]
    carry = list(arrays[n_data:n_data + n_states])
    free = list(arrays[n_data + n_states:])
    fn = _sub_fn(subgraph, sub_args, _train)
    ys = [[] for _ in range(n_out)]
    for t in range(data[0].shape[0]):
        outs = fn([d[t] for d in data] + carry + free)
        for k in range(n_out):
            ys[k].append(outs[k])
        carry = list(outs[n_out:])
    res = [torch.stack(y) for y in ys] + carry
    return tuple(res) if len(res) != 1 else res[0]


@register("_while_loop", needs_rng=True, needs_mode=True,
          num_outputs=lambda attrs: int(attrs["n_out"]) + int(attrs["n_lv"]))
def _while_loop(gen, *arrays, cond_subgraph="", body_subgraph="",
                cond_args="", body_args="", lv_names="", n_lv=0, n_out=0,
                max_iterations=0, _train=False):
    """``while cond(lv): outputs, lv = body(lv)`` for at most
    ``max_iterations`` steps, bounded and masked: the step outputs stacked
    to ``max_iterations`` rows (zero past the stop), then the final loop
    variables."""
    n_lv, n_out = int(n_lv), int(n_out)
    lv = list(arrays[:n_lv])
    lvn = _split_csv(lv_names)
    env_free = dict(zip(_free_names(cond_args, body_args, lvn),
                        arrays[n_lv:]))
    cfn = _sub_fn(cond_subgraph, cond_args, _train)
    bfn = _sub_fn(body_subgraph, body_args, _train)

    def bind(names, lv_now, keep=None):
        env = dict(env_free)
        env.update(zip(lvn, lv_now))
        vals = [env[nm] for nm in _split_csv(names)]
        return vals if keep is None else [gate(keep, v) for v in vals]

    device = lv[0].device
    active = torch.ones((), dtype=torch.bool, device=device)
    ys = [[] for _ in range(n_out)]
    for _ in range(int(max_iterations)):
        cval = cfn(bind(cond_args, lv))[0].reshape(()).to(torch.bool)
        active = torch.logical_and(active, cval)
        bouts = bfn(bind(body_args, lv, active))
        for k in range(n_out):
            o = bouts[k]
            ys[k].append(select(active, o, torch.zeros_like(o)))
        lv = [select(active, n, o) for n, o in zip(bouts[n_out:], lv)]
    res = [torch.stack(y) for y in ys] + lv
    return tuple(res) if len(res) != 1 else res[0]


@register("_cond", needs_rng=True, needs_mode=True,
          num_outputs=lambda attrs: int(attrs["n_out"]))
def _cond(gen, *arrays, then_subgraph="", else_subgraph="", then_args="",
          else_args="", n_out=0, _train=False):
    """``then(free) if pred else else(free)``: both branches run, each
    behind its gate, and the outputs are selected by ``pred``."""
    pred, free = arrays[0], arrays[1:]
    env = dict(zip(_free_names(then_args, else_args), free))
    pv = pred.reshape(()).to(torch.bool)
    taken = {"then": pv, "else": torch.logical_not(pv)}
    outs = {}
    for branch, sub, names in (("then", then_subgraph, then_args),
                               ("else", else_subgraph, else_args)):
        ins = [gate(taken[branch], env[nm]) for nm in _split_csv(names)]
        outs[branch] = _sub_fn(sub, names, _train)(ins)
    res = [select(pv, t, e) for t, e in zip(outs["then"], outs["else"])]
    return tuple(res) if len(res) != 1 else res[0]
