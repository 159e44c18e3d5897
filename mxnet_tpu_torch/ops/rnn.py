"""The fused RNN op family: the port of `mxnet_tpu/ops/rnn.py` (parity the
reference's `RNN` operator, `src/operator/rnn.cc` / `rnn-inl.h`, which runs
cuDNN on a GPU, and `_rnn_param_concat`, which `gluon.rnn`'s layers feed
it through).

The parameters arrive as MXNet's flat vector (`_slice_params`): all
weights first (layer-major, direction-minor, i2h then h2h), then all
biases, then the LSTM projections; gate order ``[i, f, g, o]`` for an LSTM
and ``[r, z, n]`` for a GRU, as cuDNN's and torch's. Every layer and
direction reads views of that vector, so the gradient lands in it.

Two routes, chosen by the op's attributes alone (`rnn_route`):

- ``fused``: one `torch._VF` call (`lstm`, `gru`, `rnn_tanh`, `rnn_relu`)
  per layer, both directions in it, with its own dropout off; cuDNN on a
  card. cuDNN keeps its weights in a packed buffer of its own layout, so
  each call repacks the views into one (the cost `PERF.md` records).
  Between layers, in training and not after the last, the port's Dropout
  draws from the generator of the data's device (the JAX op's
  ``rnn.py:255-258``).
- ``step``: the recurrence written out step by step (the hoisted input
  product, then one product and the gate math a step), for what the fused
  call cannot express: the LSTM cell clip (``lstm_state_clip_*``) and
  ``use_sequence_length``, whose padded steps freeze the carry and output
  zeros (the JAX op's ``rnn.py:108-116``); and whenever ``cudnn_off`` is
  set, which is how the two routes are held to each other.

`ROUTE_CALLS` counts the calls of each route that compute values (not the
shape-only runs on ``meta`` tensors).

A GRU's h-side bias sits inside the reset gate's product,
``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``: the JAX op's formula
(``rnn.py:149-155``) and torch's.
"""
from __future__ import annotations

import torch

from ._utils import parse_bool
from .nn import _dropout
from .registry import register

__all__ = ["rnn_param_size", "rnn_route", "ROUTE_CALLS", "reset_routes"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

ROUTE_CALLS = {"fused": 0, "step": 0}


def reset_routes():
    for k in ROUTE_CALLS:
        ROUTE_CALLS[k] = 0


def rnn_param_size(num_layers, state_size, input_size, mode,
                   bidirectional=False, projection_size=None):
    """Total flat parameter count (the reference's GetRnnParamSize,
    `rnn-inl.h:63-88`, with the LSTM projection)."""
    ndir = 2 if bidirectional else 1
    g = _GATES[mode]
    hid = projection_size if projection_size else state_size
    total = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else hid * ndir
        total += ndir * g * state_size * (isz + hid + 2)
    if projection_size:
        total += projection_size * state_size * num_layers * ndir
    return total


def _slice_params(params, num_layers, state_size, input_size, mode, ndir,
                  proj_size=None):
    """[(wi, wh, bi, bh, wproj or None)] for each (layer, direction), views
    of the flat vector in the reference's layout."""
    g = _GATES[mode]
    hid = proj_size if proj_size else state_size
    off = 0

    def take(n, shape=None):
        nonlocal off
        piece = params[off:off + n]
        off += n
        return piece if shape is None else piece.view(shape)

    weights = []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else hid * ndir
        for _ in range(ndir):
            wi = take(g * state_size * isz, (g * state_size, isz))
            wh = take(g * state_size * hid, (g * state_size, hid))
            weights.append((wi, wh))
    biases = [(take(g * state_size), take(g * state_size))
              for _ in range(num_layers * ndir)]
    projs = [take(proj_size * state_size, (proj_size, state_size))
             if proj_size else None for _ in range(num_layers * ndir)]
    return [(w[0], w[1], b[0], b[1], r)
            for w, b, r in zip(weights, biases, projs)]


def rnn_route(lstm_state_clip_min=None, lstm_state_clip_max=None,
              use_sequence_length=False, cudnn_off=False, **_):
    """``"step"`` or ``"fused"``, from the op's attributes only (the
    others are taken and ignored)."""
    if parse_bool(cudnn_off) or parse_bool(use_sequence_length):
        return "step"
    if lstm_state_clip_min is not None or lstm_state_clip_max is not None:
        return "step"
    return "fused"


def _step_direction(x, h0, c0, wi, wh, bi, bh, mode, reverse, wproj,
                    seq_len, clip):
    """One direction of one layer, step by step. x: [T, N, I] ->
    ([T, N, H|P], hT, cT or None)."""
    T = x.shape[0]
    H = wh.shape[0] // _GATES[mode]
    # the input product hoisted out of the loop: one product for all steps
    xw = torch.nn.functional.linear(x, wi, bi if mode == "gru" else bi + bh)
    h, c = h0, c0
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if mode == "lstm":
            pre = xw[t] + h @ wh.t()
            i, f, g, o = pre.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            if clip is not None:
                if clip[2]:
                    c_new = torch.nan_to_num(c_new, nan=0.0)
                c_new = torch.clamp(c_new, clip[0], clip[1])
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            if wproj is not None:
                h_new = h_new @ wproj.t()
        elif mode == "gru":
            hr = h @ wh.t() + bh
            xt = xw[t]
            r = torch.sigmoid(xt[:, :H] + hr[:, :H])
            z = torch.sigmoid(xt[:, H:2 * H] + hr[:, H:2 * H])
            n = torch.tanh(xt[:, 2 * H:] + r * hr[:, 2 * H:])
            h_new = (1 - z) * n + z * h
        else:
            pre = xw[t] + h @ wh.t()
            h_new = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        if seq_len is not None:
            m = (t < seq_len).unsqueeze(1)
            h_new = torch.where(m, h_new, h)
            if mode == "lstm":
                c_new = torch.where(m, c_new, c)
            outs[t] = torch.where(m, h_new, torch.zeros((), dtype=h_new.dtype,
                                                        device=h_new.device))
        else:
            outs[t] = h_new
        h = h_new
        if mode == "lstm":
            c = c_new
    return torch.stack(outs), h, (c if mode == "lstm" else None)


def _fused_layer(x, h0, c0, params, mode, ndir, train):
    """One layer, both directions, through one `torch._VF` call. params:
    the layer's (wi, wh, bi, bh, wproj) for each direction. Returns (ys,
    [hT of each direction], [cT of each direction] or None)."""
    flat = []
    for wi, wh, bi, bh, wproj in params:
        flat += [wi, wh, bi, bh] + ([wproj] if wproj is not None else [])
    fn = getattr(torch._VF, mode)  # lstm, gru, rnn_tanh, rnn_relu
    bidir = ndir == 2
    if mode == "lstm":
        ys, hT, cT = fn(x, (h0, c0), flat, True, 1, 0.0, train, bidir, False)
        return ys, list(hT.unbind(0)), list(cT.unbind(0))
    ys, hT = fn(x, h0, flat, True, 1, 0.0, train, bidir, False)
    return ys, list(hT.unbind(0)), None


@register("RNN", needs_rng=True, needs_mode=True,
          tensor_opts=("sequence_length",),
          num_outputs=lambda attrs: 1 + (
              (2 if attrs.get("mode") == "lstm" else 1)
              if parse_bool(attrs.get("state_outputs", False)) else 0))
def _rnn(gen, data, parameters, state, *maybe_state_cell, state_size=None,
         num_layers=1, mode="lstm", bidirectional=False, p=0.0,
         state_outputs=False, projection_size=None, lstm_state_clip_min=None,
         lstm_state_clip_max=None, lstm_state_clip_nan=False,
         use_sequence_length=False, sequence_length=None, cudnn_off=False,
         _train=False, **kw):
    """Fused multi-layer (bi)directional RNN (reference `rnn.cc`).

    data [T, N, I]; parameters: the flat vector (`_slice_params`); state
    [L*D, N, H] ([L*D, N, P] for a projected LSTM); state_cell [L*D, N, H]
    for an LSTM. With ``use_sequence_length`` an extra ``sequence_length``
    [N] input masks padded steps (outputs zero, final states from the last
    valid step). ``projection_size`` makes an LSTMP;
    ``lstm_state_clip_min/max/nan`` clip the cell state each step. ``p``
    is the dropout between layers in training. Returns the output [T, N,
    H*D] (and the final states with ``state_outputs``). The route:
    `rnn_route`."""
    from ..base import MXNetError

    mode = str(mode)
    state_size = int(state_size)
    num_layers = int(num_layers)
    ndir = 2 if parse_bool(bidirectional) else 1
    p = float(p)
    train = parse_bool(_train)
    proj = int(projection_size) if projection_size not in (None, "None", 0) \
        else None
    clip_min = None if lstm_state_clip_min in (None, "None") \
        else float(lstm_state_clip_min)
    clip_max = None if lstm_state_clip_max in (None, "None") \
        else float(lstm_state_clip_max)
    if (proj or clip_min is not None or clip_max is not None) \
            and mode != "lstm":
        raise MXNetError("projection_size / lstm_state_clip_* are only "
                         "supported for mode='lstm' (reference "
                         "rnn-inl.h:435-442)")
    maybe_state_cell = list(maybe_state_cell)
    use_len = parse_bool(use_sequence_length)
    if use_len and sequence_length is None:
        # the extra input arrives positionally after the states
        if not maybe_state_cell:
            raise MXNetError("use_sequence_length=True requires a "
                             "sequence_length input")
        sequence_length = maybe_state_cell.pop()
    seq_len = sequence_length.long() if use_len else None
    route = rnn_route(clip_min, clip_max, use_len, cudnn_off)
    if data.device.type != "meta":
        ROUTE_CALLS[route] += 1

    # the recurrence runs in the promoted dtype of its inputs, the output
    # in the data's (the JAX op's `rnn.py:260-265`)
    c0_all = maybe_state_cell[0] if maybe_state_cell else None
    dt = torch.result_type(data, parameters)
    x = data.to(dt)
    h0_all = state.to(dt)
    c0_all = c0_all.to(dt) if c0_all is not None else None
    layers = _slice_params(parameters.to(dt), num_layers, state_size,
                           x.shape[-1], mode, ndir, proj_size=proj)
    clip = None if clip_min is None and clip_max is None else \
        (clip_min, clip_max, parse_bool(lstm_state_clip_nan))

    hT_list, cT_list = [], []
    for layer in range(num_layers):
        lo = layer * ndir
        lp = layers[lo:lo + ndir]
        if route == "fused":
            x, hTs, cTs = _fused_layer(
                x, h0_all[lo:lo + ndir],
                c0_all[lo:lo + ndir] if c0_all is not None else None,
                lp, mode, ndir, train)
            hT_list += hTs
            cT_list += cTs or []
        else:
            outs = []
            for d in range(ndir):
                wi, wh, bi, bh, wproj = lp[d]
                ys, hT, cT = _step_direction(
                    x, h0_all[lo + d],
                    c0_all[lo + d] if c0_all is not None else None,
                    wi, wh, bi, bh, mode, d == 1, wproj, seq_len, clip)
                outs.append(ys)
                hT_list.append(hT)
                if cT is not None:
                    cT_list.append(cT)
            x = torch.cat(outs, dim=-1) if ndir == 2 else outs[0]
        if train and p > 0 and layer < num_layers - 1:
            x = _dropout(gen, x, p=p, _train=True)

    out = x.to(data.dtype)
    if not parse_bool(state_outputs):
        return out
    hT = torch.stack(hT_list).to(data.dtype)
    if mode == "lstm":
        return out, hT, torch.stack(cT_list).to(data.dtype)
    return out, hT


@register("_rnn_param_concat")
def _rnn_param_concat(*arrays, dim=0, num_args=None, **kw):
    """The per-gate parameter pieces flattened into the fused op's flat
    vector (reference `_rnn_param_concat`, rnn_layer.py)."""
    return torch.cat([a.reshape(-1) for a in arrays], dim=0)
