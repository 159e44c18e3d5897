"""Connectionist temporal classification loss: the port of
`mxnet_tpu/ops/ctc.py` (the reference's `src/operator/nn/ctc_loss.cc`,
``_contrib_CTCLoss``, alias ``ctc_loss``).

``data`` is (T, N, C) unnormalized activations (softmax is applied
inside), ``label`` (N, L) class indices. With ``blank_label="first"`` the
blank is 0 (labels 1 .. C-1, padded with 0); with ``"last"`` it is C-1
(labels 0 .. C-2, padded with -1). The optional ``data_lengths`` and
``label_lengths`` (N,) apply when ``use_data_lengths`` /
``use_label_lengths`` are set; without label lengths a label ends at its
first padding value. The output is each sample's negative
log-likelihood, (N,).

As in the JAX package, the forward is the log-space alpha recursion of
Graves et al. (2006) over the blank-interleaved label (S = 2L + 1 states),
in fp32, with -1e30 standing in for log 0 so that no step gives NaN, and
autograd differentiates it: a sample with no valid alignment gets a large
finite loss (about 1e30), where `torch.nn.functional.ctc_loss` would give
infinity. ``logaddexp`` carries jax's gradient rule, d/dx1 = exp(x1 -
out): where two stand-ins meet (-1e30 + log 2 rounds to -1e30) each side
gets 1, not torch's 1/2, so a sample with no alignment has the JAX op's
gradient too.
"""
from __future__ import annotations

import torch

from ._utils import parse_bool
from .registry import register

_NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) as jax computes it and differentiates it."""

    @staticmethod
    def forward(ctx, a, b):
        delta = a - b
        out = torch.where(torch.isnan(delta), a + b, torch.maximum(a, b)
                          + torch.log1p(torch.exp(-torch.abs(delta))))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors

        def finite(x):
            return torch.where(torch.isposinf(x), torch.zeros_like(x), x)

        return (g * torch.exp(finite(a) - finite(out)),
                g * torch.exp(finite(b) - finite(out)))


_logaddexp = _LogAddExp.apply


@register("CTCLoss", aliases=["ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"],
          tensor_opts=("data_lengths", "label_lengths"))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first", **kw):
    if blank_label not in ("first", "last"):
        raise ValueError(
            f"blank_label must be 'first' or 'last', got {blank_label!r}")
    t_len, n, c = data.shape
    s = 2 * label.shape[1] + 1
    dev = data.device
    logp = torch.log_softmax(data.to(torch.float32), dim=-1)   # (T, N, C)
    labels = label.long()
    blank = 0 if blank_label == "first" else c - 1
    pad = 0 if blank_label == "first" else -1
    if parse_bool(use_label_lengths) and label_lengths is not None:
        lab_len = label_lengths.long()
    else:
        # the first padding value ends the label
        is_pad = labels == pad
        first = torch.argmax(is_pad.to(torch.int32), dim=1)
        lab_len = torch.where(is_pad.any(dim=1), first, labels.shape[1])
    if parse_bool(use_data_lengths) and data_lengths is not None:
        dat_len = data_lengths.long()
    else:
        dat_len = torch.full((n,), t_len, dtype=torch.long, device=dev)

    # the extended label [blank, l0, blank, l1, ..., blank]: (N, S)
    ext = torch.full((n, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = torch.clamp(labels, 0, c - 1)
    # s - 2 -> s is allowed onto a label that differs from the one before
    same = torch.zeros((n, s), dtype=torch.bool, device=dev)
    same[:, 2:] = ext[:, 2:] == ext[:, :-2]
    odd = (torch.arange(s, device=dev) % 2) == 1
    allow_skip = odd[None, :] & ~same
    lp_ext = torch.gather(logp, 2, ext[None].expand(t_len, n, s))
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=dev)

    valid1 = lab_len > 0
    alpha = torch.full((n, s), _NEG_INF, dtype=torch.float32, device=dev)
    alpha = torch.cat([lp_ext[0][:, :1],
                       torch.where(valid1, lp_ext[0][:, 1], neg)[:, None],
                       alpha[:, 2:]], dim=1) if s > 1 else lp_ext[0][:, :1]
    pad1 = torch.full((n, 1), _NEG_INF, dtype=torch.float32, device=dev)
    pad2 = torch.full((n, 2), _NEG_INF, dtype=torch.float32, device=dev)
    for t in range(1, t_len):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(allow_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         neg)
        new = _logaddexp(_logaddexp(alpha, a1), a2) + lp_ext[t]
        # a sequence already over keeps its alphas
        alpha = torch.where((t < dat_len)[:, None], new, alpha)

    # the last blank (2 L) and the last label (2 L - 1)
    end_b = torch.gather(alpha, 1, (2 * lab_len)[:, None])[:, 0]
    end_l = torch.gather(alpha, 1, torch.clamp(2 * lab_len - 1, 0, s - 1)
                         [:, None])[:, 0]
    end_l = torch.where(valid1, end_l, neg)
    return (-_logaddexp(end_b, end_l)).to(data.dtype)
