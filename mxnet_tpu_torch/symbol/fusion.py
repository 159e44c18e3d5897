"""Conv+BN(+ReLU) fusion, the ``TPU_FUSE`` SubgraphProperty: the port of
`mxnet_tpu/symbol/fusion.py`.

Parity role: the MKLDNN conv fusion backend
(`src/operator/subgraph/mkldnn/mkldnn_conv.cc` + its
`MXNET_REGISTER_SUBGRAPH_PROPERTY(MKLDNN, ...)`): Convolution → BatchNorm
(→ relu) chains collapse into one `_fused_conv_bn_relu` node with the BN
folded into the convolution parameters at run time. Inference-only (the
fused op consumes the moving statistics), like the reference's deployment
fusions; registered as backend ``TPU_FUSE``:

    fused = sym.get_backend_symbol("TPU_FUSE")
"""
from __future__ import annotations

from .subgraph import (SubgraphProperty, SubgraphSelector,
                       register_subgraph_property)


def _is_relu(node):
    """Either spelling of ReLU: the `Activation(act_type='relu')` op or
    the standalone `relu` op (gluon emits the former, hand-built symbols
    and imported graphs often the latter)."""
    if node.op == "relu":
        return True
    return node.op == "Activation" and \
        str(node.attrs.get("act_type", "")) == "relu"


class _ConvBNReLUSelector(SubgraphSelector):
    def select(self, node):
        return node.op == "Convolution"

    def select_output(self, node, output_node):
        if node.op == "Convolution" and output_node.op == "BatchNorm":
            # BN must consume THIS conv's main output
            return bool(output_node.inputs) and output_node.inputs[0][0] is node
        if node.op == "BatchNorm" and _is_relu(output_node):
            return bool(output_node.inputs) and output_node.inputs[0][0] is node
        return False


class ConvBNReLUProperty(SubgraphProperty):
    def create_subgraph_selector(self):
        return _ConvBNReLUSelector()

    def create_subgraph_node(self, subgraph_sym, input_entries, subgraph_id):
        from .symbol import _apply_op

        nodes = subgraph_sym._nodes()
        conv = next((n for n in nodes if n.op == "Convolution"), None)
        bn = next((n for n in nodes if n.op == "BatchNorm"), None)
        act = next((n for n in nodes if n.op and _is_relu(n)), None)
        if conv is None or bn is None or len(subgraph_sym._outputs) != 1:
            return None  # not the exact shape this fusion handles
        names = (subgraph_sym.list_arguments()
                 + subgraph_sym.list_auxiliary_states())
        entry = dict(zip(names, input_entries))

        def of(node, i):
            child, _ = node.inputs[i]
            return entry.get(child.name)

        data = of(conv, 0)
        weight = of(conv, 1)
        bias = of(conv, 2) if len(conv.inputs) > 2 else None
        gamma, beta = of(bn, 1), of(bn, 2)
        mean, variance = of(bn, 3), of(bn, 4)
        if any(x is None for x in (data, weight, gamma, beta, mean, variance)):
            return None  # a role is fed by an inner node — bail out
        if bias is None:
            bias = _apply_op("_zeros",
                             shape=(int(conv.attrs.get("num_filter", 0)),),
                             dtype="float32")
        attrs = fused_conv_bn_attrs(conv.attrs, bn.attrs, act is not None)
        return _apply_op(
            "_fused_conv_bn_relu", data, weight, bias, gamma, beta, mean,
            variance, name=f"fused_conv{subgraph_id}", **attrs)


def fused_conv_bn_attrs(conv_attrs, bn_attrs, with_relu):
    """The `_fused_conv_bn_relu` attrs from a Convolution and a BatchNorm's
    (the port's copy of `mxnet_tpu/lazy/rewrite.py:120`)."""
    attrs = {k: v for k, v in dict(conv_attrs).items()
             if k in ("kernel", "stride", "dilate", "pad", "num_filter",
                      "num_group", "layout")}
    bn = dict(bn_attrs)
    attrs["eps"] = bn.get("eps", 1e-3)
    attrs["fix_gamma"] = bn.get("fix_gamma", True)
    attrs["with_relu"] = bool(with_relu)
    return attrs


register_subgraph_property("TPU_FUSE", ConvBNReLUProperty)
