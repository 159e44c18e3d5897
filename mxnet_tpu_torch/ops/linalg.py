"""Matrix products: ``dot`` and ``batch_dot`` of `mxnet_tpu/ops/linalg.py`
(`tensor/dot-inl.h`). They run on cuBLAS; half inputs accumulate in fp32
there. The rest of the JAX module (`khatri_rao`, the `_linalg_*` family) is
not ported yet (ROADMAP.md queue A)."""
from __future__ import annotations

import torch

from ._utils import parse_bool
from .registry import register


@register("dot")
def _dot(a, b, transpose_a=False, transpose_b=False, forward_stype=None,
         **kw):
    """Contracts the last axis of a with the first axis of b; the transpose
    flags contract a's first axis or b's last instead."""
    ta, tb = parse_bool(transpose_a), parse_bool(transpose_b)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    a_axis = 0 if ta else a.dim() - 1
    b_axis = b.dim() - 1 if tb else 0
    return torch.tensordot(a, b, dims=([a_axis], [b_axis]))


@register("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False, forward_stype=None,
               **kw):
    if parse_bool(transpose_a):
        a = a.transpose(-1, -2)
    if parse_bool(transpose_b):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)
