"""Ops behind the subgraph framework: the port of the `_subgraph_exec` and
`_fused_conv_bn_relu` ops of `mxnet_tpu/ops/subgraph_ops.py`.

`_subgraph_exec` is the opaque region node the default `SubgraphProperty`
emits: the region travels as Symbol JSON in an attribute and runs through
the executor's graph function (`symbol/executor.py` `_graph_fn`).

`_fused_conv_bn_relu` is what the ``TPU_FUSE`` backend folds a
Convolution -> BatchNorm (-> ReLU) chain into: the BatchNorm's moving
statistics fold into the convolution's weight and bias, then the ReLU.
Inference only, like the reference's deployment fusions. The convolution
is the port's `Convolution` (cuDNN on a card), as the JAX op calls XLA's.
"""
from __future__ import annotations

import json

import torch

from ._utils import parse_bool
from .nn import _convolution
from .registry import register


@register("_subgraph_exec", needs_rng=True, needs_mode=True,
          num_outputs=lambda attrs: int(attrs["n_out"]))
def _subgraph_exec(gen, *args, subgraph=None, arg_names="", n_out=1,
                   _train=False, **kw):
    """The region ``subgraph`` (Symbol JSON) over ``args``, bound in the
    order of ``arg_names``. Each node of the region that draws random
    numbers draws from its device's generator, so ``gen`` goes unused."""
    from ..symbol import symbol as _sym
    from ..symbol.executor import _graph_fn

    names = [n for n in str(arg_names).split(",") if n]
    # a JSON round trip of the outer symbol may parse the attr into a dict
    inner = _sym.load_json(subgraph if isinstance(subgraph, str)
                           else json.dumps(subgraph))
    outs, _ = _graph_fn(inner, names, [], bool(_train))(tuple(args), ())
    return outs if int(n_out) > 1 else outs[0]


@register("_fused_conv_bn_relu")
def _fused_conv_bn_relu(data, weight, bias, gamma, beta, moving_mean,
                        moving_var, kernel=(1, 1), stride=(), dilate=(),
                        pad=(), num_filter=0, num_group=1, no_bias=False,
                        layout="NCHW", eps=1e-5, fix_gamma=False,
                        with_relu=True, **kw):
    """relu(BN(conv(x))) with the BatchNorm folded into the convolution:
    w' = w * s, b' = (b - mean) * s + beta, s = gamma / sqrt(var + eps),
    with gamma taken as ones under ``fix_gamma``."""
    g = torch.ones_like(moving_var) if parse_bool(fix_gamma) else gamma
    s = g / torch.sqrt(moving_var + float(eps))
    w = weight * s.reshape((-1,) + (1,) * (weight.dim() - 1))
    b = (bias - moving_mean) * s + beta
    out = _convolution(data, w, b, kernel=kernel, stride=stride,
                       dilate=dilate, pad=pad, num_filter=num_filter,
                       num_group=num_group, layout=layout)
    return torch.relu(out) if parse_bool(with_relu) else out
