"""The port's op registry (`mxnet_tpu_torch.ops`) held to the JAX package's
on the CPU, op by op, from `chip_smoke.py`'s case table: the same numpy
inputs through the JAX op (its registered function and `jax.vjp` for the
gradient, every case in one jitted program) and through the port's `mx.nd` frontend (and
`autograd.backward`). Forward outputs, gradients and the inputs after the
call (the arrays that ``mutate_aux`` ops write) agree at rtol 1e-4 /
atol 1e-6 for fp32 (`mxnet_tpu/test_utils.py:142-160`) and 1e-3 for fp16.

Dropout draws from torch's generators, whose stream cannot be threefry's:
its training mode is held to its statistics (`dropout_keep_rate`); so are
the random ops (`chip_smoke.RANDOM_OPS`, in `test_torch_random.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

TOL = {"float32": (1e-4, 1e-6), "float16": (1e-3, 1e-3)}
ALL_CASES = cs.op_cases()
CASES = [c for c in ALL_CASES if c[1] not in cs.RANDOM_OPS]
JAX_OP_FILES = ("elemwise", "broadcast", "reduce", "shape_ops", "indexing",
                "init_ops", "nn", "optimizer_ops", "random_ops", "ctc", "rnn",
                "control_flow_ops", "image_ops")
# the names ported from files the port holds only in part
PORTED_NN = ("ROIPooling", "SpatialTransformer", "Correlation", "SVMOutput",
             "dot", "batch_dot")


def aux_inputs(op, attrs):
    """The inputs an op's trailing outputs are written into: ``mutate_aux``
    is a tuple, or a function of the attrs (the ``multi_*`` ops)."""
    aux = op.mutate_aux or ()
    return aux(attrs) if callable(aux) else aux


# data-dependent output shapes, and the host ops (eager_only in the JAX
# package): run eagerly, outside the one jitted program
EAGER = ("_contrib_boolean_mask", "contrib_boolean_mask", "_ag_getitem",
         "_cvimdecode", "cvimdecode", "_cvimread", "cvimread", "_cvimresize",
         "cvimresize", "_cvcopyMakeBorder", "cvcopyMakeBorder")


def jax_case(case, args, cts):
    """The JAX op on the case's inputs (jnp arrays): its outputs, and with
    the port's cotangents on its float outputs, the gradients."""
    _, name, _, attrs, _ = case
    op = jreg.get_op(name)
    attrs = dict(attrs)
    if op.wrap_kwargs is not None:
        attrs = op.wrap_kwargs(attrs)
    if not args:
        attrs["ctx"] = None
    diff = cs.op_case_grad_inputs(case)
    key = [jax.random.PRNGKey(0)] if op.needs_rng else []

    def f(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        outs = op.fn(*key, *full, **attrs)
        return outs if isinstance(outs, tuple) else (outs,)

    if not diff:
        return f(), ()
    outs, vjp = jax.vjp(f, *[args[i] for i in diff])
    n_user = len(outs) - len(aux_inputs(op, attrs))
    floats = iter(cts)
    full_cts = []
    for k, o in enumerate(outs):
        if not jnp.issubdtype(o.dtype, jnp.floating):
            full_cts.append(np.zeros(o.shape, jax.dtypes.float0))
        elif k < n_user:
            full_cts.append(next(floats))
        else:
            full_cts.append(jnp.zeros(o.shape, o.dtype))
    return outs, vjp(tuple(full_cts))


@pytest.fixture(scope="module")
def results():
    """{case id: (port result, JAX result)}: the port's runs first, for
    their cotangents; then every JAX case in one jitted program, since a
    compile per case would cost seconds."""
    port = {c[0]: cs.port_op_case(mx, c, cs.op_case_arrays(c), mx.cpu())
            for c in CASES}
    inputs = {c[0]: ([jnp.asarray(a) for a in cs.op_case_arrays(c)],
                     [jnp.asarray(x) for x in port[c[0]][3]])
              for c in CASES}
    jitted = [c for c in CASES if c[1] not in EAGER]
    ref = jax.jit(lambda ins: {c[0]: jax_case(c, *ins[c[0]])
                               for c in jitted})(
        {c[0]: inputs[c[0]] for c in jitted})
    ref.update({c[0]: jax_case(c, *inputs[c[0]]) for c in CASES
                if c[1] in EAGER})
    return {k: (port[k], ref[k]) for k in port}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case, results):
    got, (outs, gs) = results[case[0]]
    op = jreg.get_op(case[1])
    aux = aux_inputs(op, case[3])
    n_user = len(outs) - len(aux)
    after = cs.op_case_arrays(case)
    for j, in_idx in enumerate(aux):
        after[in_idx] = outs[n_user + j]
    want = ([np.asarray(o) for o in outs[:n_user]],
            dict(zip(cs.op_case_grad_inputs(case), map(np.asarray, gs))),
            [np.asarray(a) for a in after])
    cs.assert_op_case_close(case, got, want, tols=TOL)


def test_every_jax_op_name_is_registered_with_a_case():
    """The coverage case: every name the JAX registry takes from the
    thirteen op files ported whole (384), plus the ported vision and
    product ops, is registered in the port, and every registered name has
    a case in the table (392 of the JAX registry's 471)."""
    want = {n for n in jreg.list_ops()
            if jreg.get_op(n).fn.__module__.rsplit(".", 1)[-1]
            in JAX_OP_FILES}
    assert len(want) == 384
    want |= set(PORTED_NN)
    assert not want - set(treg.list_ops())
    assert set(treg.list_ops()) == {c[1] for c in ALL_CASES}
    assert len(treg.list_ops()) == 392
    # an alias names the same op in both registries
    for name in want:
        assert treg.get_op(name) is treg.get_op(jreg.get_op(name).name), name


def test_dropout_training_statistics_and_seed():
    kept = cs.dropout_keep_rate(mx, mx.cpu())
    assert abs(kept - 0.5) < 0.05
    x = mx.nd.ones((64,), ctx=mx.cpu())

    def mask():
        with mx.autograd.train_mode():
            return mx.nd.Dropout(x, p=0.5).asnumpy()

    mx.random.seed(7)
    first = mask()
    assert not np.array_equal(first, mask())  # the stream moves on
    mx.random.seed(7, ctx=mx.cpu())
    np.testing.assert_array_equal(first, mask())


def test_unknown_attr_raises_and_shape_inference_on_meta():
    x = mx.nd.ones((2, 3), ctx=mx.cpu())
    with pytest.raises(MXNetError, match="unknown argument"):
        mx.nd.sum(x, axes=1)
    # the reference's performance hints are accepted and ignored
    w = mx.nd.ones((4, 3, 3, 3), ctx=mx.cpu())
    mx.nd.Convolution(mx.nd.ones((1, 3, 5, 5), ctx=mx.cpu()), w,
                      kernel=(3, 3), num_filter=4, no_bias=True,
                      cudnn_tune="off", workspace=512)
    shapes = treg.infer("Convolution", ((2, 3, 9, 9), "float32"),
                        ((8, 3, 3, 3), "float32"), kernel=(3, 3),
                        stride=(2, 2), pad=(1, 1), num_filter=8, no_bias=True)
    assert shapes == [((2, 8, 5, 5), torch.float32)]
    assert treg.infer("BatchNorm", ((2, 4, 3, 3), "bfloat16"),
                      *[((4,), "float32")] * 4, _train=True)[0] == \
        ((2, 4, 3, 3), torch.bfloat16)


def test_positional_scalars_bind_like_the_reference():
    """``nd.clip(x, 0, 1)``: positional scalars bind to the op's keyword
    attrs in declaration order, in both packages."""
    import mxnet_tpu as jmx

    a = np.linspace(-2, 2, 8).astype(np.float32)
    got = mx.nd.clip(mx.nd.array(a, ctx=mx.cpu()), 0, 1).asnumpy()
    want = jmx.nd.clip(jmx.nd.array(a), 0, 1).asnumpy()
    np.testing.assert_array_equal(got, want)
