"""The port's optimizers (`mxnet_tpu_torch.optimizer`) held to the JAX
package's (`mxnet_tpu.optimizer`) on the CPU: the same weights and gradients,
made with numpy, through three updates of one `Updater` on each side.

Tolerances: fp32 weights and states within 1e-6 relative, plus 1e-8
absolute. Both sides run the same fp32 arithmetic, but XLA on the CPU
contracts ``a * b + c`` into one fused multiply-add (one rounding) where
torch rounds the product first, so a result can differ by an ulp of its
larger term; when the terms cancel (momentum ``0.9 * m - lr * g``) that ulp
is large next to the result. 1e-8 is about two ulps at the terms' size
(~0.05). With multi_precision on bf16 weights, the fp32 master and the
states within the same bounds, and the bf16 weights exactly equal: each is
the master rounded to bf16 on both sides.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt

RTOL, ATOL = 1e-6, 1e-8

OPTIMIZERS = {
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "adam": ("adam", {"learning_rate": 0.01}),
    "test": ("test", {}),
}
OPTIONS = {
    "defaults": {},
    "rescale_wd_clip": {"rescale_grad": 0.5, "wd": 0.01,
                        "clip_gradient": 0.3},
}
SHAPE = (5, 7)


def _leaves(state):
    """The state tree's tensors in order, as fp32 numpy arrays."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    if isinstance(state, torch.Tensor):
        return [state.float().numpy()]
    return [np.asarray(state.asnumpy(), np.float32)]


def _run_both(name, kwargs, dtype):
    """Three updates on each side; returns (port, jax) as
    (weight fp32 numpy, state leaves)."""
    rng = np.random.RandomState(0)
    w0 = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    grads = [rng.uniform(-1, 1, SHAPE).astype(np.float32) for _ in range(3)]
    tdt = getattr(torch, dtype)
    w = torch.nn.Parameter(torch.from_numpy(w0).to(tdt))
    # a copy: JAX on the CPU may alias a numpy buffer, which the port's
    # in-place updates of w would then change under it
    jw = mx.nd.array(w.detach().float().numpy().copy(), dtype=dtype)
    upd = topt.get_updater(topt.create(name, **kwargs))
    jupd = mx.optimizer.get_updater(mx.optimizer.create(name, **kwargs))
    for g in grads:
        gt = torch.from_numpy(g).to(tdt)
        upd(0, gt, w)
        jupd(0, mx.nd.array(gt.float().numpy(), dtype=dtype), jw)
    assert w.dtype == tdt and isinstance(w, torch.nn.Parameter)
    return ((w.detach().float().numpy(), _leaves(upd.states[0])),
            (np.asarray(jw.asnumpy(), np.float32), _leaves(jupd.states[0])))


@pytest.mark.parametrize("options", list(OPTIONS))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_fp32_updates_match_jax(opt, options):
    name, kwargs = OPTIMIZERS[opt]
    (w, states), (jw, jstates) = _run_both(
        name, dict(kwargs, **OPTIONS[options]), "float32")
    np.testing.assert_allclose(w, jw, rtol=RTOL, atol=ATOL)
    assert len(states) == len(jstates)
    for s, js in zip(states, jstates):
        np.testing.assert_allclose(s, js, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_multi_precision_bf16_matches_jax(opt):
    name, kwargs = OPTIMIZERS[opt]
    kwargs = dict(kwargs, multi_precision=True, **OPTIONS["rescale_wd_clip"])
    (w, states), (jw, jstates) = _run_both(name, kwargs, "bfloat16")
    np.testing.assert_array_equal(w, jw)
    # the fp32 master copy is part of the state on both sides
    assert len(states) == len(jstates) >= 1
    for s, js in zip(states, jstates):
        np.testing.assert_allclose(s, js, rtol=RTOL, atol=ATOL)


def test_registry_multipliers_and_errors():
    o = topt.create("SGD", learning_rate=0.5, wd=0.1,
                    param_idx2name={0: "fc_weight", 1: "fc_bias"})
    assert isinstance(o, topt.SGD)
    # wd applies to *_weight names only; lr_mult by index
    assert (o._get_wd(0), o._get_wd(1)) == (0.1, 0.0)
    o.set_lr_mult({1: 0.5})
    assert (o._get_lr(0), o._get_lr(1)) == (0.5, 0.25)
    # a parameter's own lr_mult / wd_mult attribute wins
    p = torch.nn.Parameter(torch.zeros(2))
    p.lr_mult = 2.0
    o.param_dict = {0: p}
    assert o._get_lr(0) == 1.0 and o._get_wd(0) == 0.1
    with pytest.raises(ValueError):
        topt.create("nonexistent")
    # a scheduler sets the base rate and is asked once per update count
    sched = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    o = topt.create("adam", learning_rate=0.2, lr_scheduler=sched)
    assert sched.base_lr == 0.2
    o.num_update = 3
    assert o._get_lrs([0, 1]) == [0.05, 0.05]
    with pytest.raises(UserWarning):
        o.set_learning_rate(0.1)


# -- groups: the fused multi-tensor update, the aggregated multi_sgd_* ops
# and one update per parameter, on gluon-style NDArray weights. Bounds of
# the JAX package's `test_aggregated_sgd_matches_sequential`
# (`tests/python/unittest/test_optimizer.py:149`): rtol 1e-6, atol 1e-6.

GROUP_SHAPES = [(5, 4), (16,), (3, 3, 2), (8, 8), (7,)]


def _group_run(pkg, momentum, fused, aggregate_num, dtype="float32",
               mp=False):
    """Three updates of five NDArray weights through one `Updater` of
    package ``pkg``; the weights and the state leaves after, fp32 numpy."""
    rng = np.random.RandomState(0)
    ws = [rng.randn(*s).astype(np.float32) for s in GROUP_SHAPES]
    gs = [rng.randn(*s).astype(np.float32) * 0.1 for s in GROUP_SHAPES]
    prev = os.environ.get("MXNET_FUSED_STEP")
    os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
    try:
        with pkg.cpu():
            o = pkg.optimizer.create("sgd", learning_rate=0.1,
                                     momentum=momentum, wd=1e-4,
                                     rescale_grad=0.5, multi_precision=mp)
            o.aggregate_num = aggregate_num
            upd = pkg.optimizer.get_updater(o)
            weights = [pkg.nd.array(w).astype(dtype) for w in ws]
            for _ in range(3):
                upd(list(range(len(ws))),
                    [pkg.nd.array(g).astype(dtype) for g in gs], weights)
    finally:
        if prev is None:
            os.environ.pop("MXNET_FUSED_STEP", None)
        else:
            os.environ["MXNET_FUSED_STEP"] = prev
    return ([np.asarray(w.asnumpy(), np.float32) for w in weights],
            [x for i in range(len(ws)) for x in _leaves(upd.states[i])])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_fused_aggregated_and_per_parameter_updates_match_jax(momentum):
    """The port's fused update, its aggregated ops in chunks of 3 + 2 and
    its per-parameter updates agree with each other and with the JAX
    package's fused and sequential updates."""
    runs = {"fused": _group_run(tmx, momentum, True, 3),
            "aggregated": _group_run(tmx, momentum, False, 3),
            "per_parameter": _group_run(tmx, momentum, False, 0),
            "jax_fused": _group_run(mx, momentum, True, 3)}
    ref_w, ref_s = _group_run(mx, momentum, False, 0)
    for name, (w, st) in runs.items():
        assert len(st) == len(ref_s), name
        for a, b in zip(w + st, ref_w + ref_s):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def test_fused_multi_precision_bf16_matches_jax():
    """bf16 weights with fp32 masters: the port's fused and aggregated
    (``multi_mp_sgd_mom_update``) updates against the JAX package's
    aggregated one; the masters and momenta within the fp32 bounds, the
    bf16 weights equal (each is its master rounded)."""
    want_w, want_s = _group_run(mx, 0.9, False, 4, "bfloat16", True)
    for fused in (True, False):
        w, st = _group_run(tmx, 0.9, fused, 4, "bfloat16", True)
        assert len(st) == len(want_s) == 2 * len(GROUP_SHAPES)
        for a, b in zip(w, want_w):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(st, want_s):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_updater_states_round_trip():
    rng = np.random.RandomState(2)
    w0 = rng.randn(4, 3).astype(np.float32)
    g = tmx.nd.array(rng.randn(4, 3), ctx=tmx.cpu())
    upd = topt.get_updater(topt.create("sgd", learning_rate=0.1,
                                       momentum=0.9))
    w = tmx.nd.array(w0, ctx=tmx.cpu())
    upd(0, g, w)
    twin = topt.get_updater(topt.create("sgd", learning_rate=0.7))
    twin.set_states(upd.get_states(dump_optimizer=True))
    assert twin.optimizer.lr == 0.1 and twin.optimizer.momentum == 0.9
    w2 = tmx.nd.array(w.asnumpy(), ctx=tmx.cpu())
    upd(0, g, w)
    twin(0, g, w2)
    np.testing.assert_array_equal(w.asnumpy(), w2.asnumpy())
    np.testing.assert_array_equal(_leaves(upd.states[0])[0],
                                  _leaves(twin.states[0])[0])
