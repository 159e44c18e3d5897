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


def _run_both(name, kwargs, dtype, steps=3):
    """``steps`` updates on each side; returns (port, jax) as
    (weight fp32 numpy, state leaves)."""
    rng = np.random.RandomState(0)
    w0 = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    grads = [rng.uniform(-1, 1, SHAPE).astype(np.float32)
             for _ in range(steps)]
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


# -- slice 13: the other optimizers, five steps each, at the JAX package's
# tolerances (`mxnet_tpu/test_utils.py:142-160`): rtol 1e-4 / atol 1e-6 for
# fp32 weights, masters and states, 1e-3 for fp16 weights.

JAX_TOL = {"rtol": 1e-4, "atol": 1e-6}
FP16_TOL = {"rtol": 1e-3, "atol": 1e-3}
MORE_OPTIMIZERS = {
    "signum": ("signum", {"learning_rate": 0.01, "momentum": 0.9,
                          "wd_lh": 0.01}),
    "signsgd": ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    "ftml": ("ftml", {"learning_rate": 0.05}),
    "dcasgd": ("dcasgd", {"learning_rate": 0.1, "lamda": 0.1}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    "nag_plain": ("nag", {"learning_rate": 0.1}),
    "adam": ("adam", {"learning_rate": 0.01, "beta1": 0.5}),
    "adamw": ("adamw", {"learning_rate": 0.01, "eta": 0.7}),
    "adagrad": ("adagrad", {"learning_rate": 0.1}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01, "clip_weights": 0.9}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 0.01,
                                     "centered": True}),
    "adadelta": ("adadelta", {"rho": 0.8}),
    "ftrl": ("ftrl", {"lamda1": 0.05}),
    "adamax": ("adamax", {}),
    "nadam": ("nadam", {}),
    "lbsgd": ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9,
                        "warmup_epochs": 1, "updates_per_epoch": 4,
                        "batch_scale": 4}),
    "lbsgd_lars": ("lbsgd", {"learning_rate": 0.1,
                             "warmup_strategy": "lars"}),
}
MORE_OPTIONS = {
    "defaults": {},
    "rescale_wd_clip": {"rescale_grad": 0.5, "wd": 0.01,
                        "clip_gradient": 0.3},
}


def _close_runs(got, want, weight_tol=JAX_TOL):
    (w, states), (jw, jstates) = got, want
    np.testing.assert_allclose(w, jw, **weight_tol)
    assert len(states) == len(jstates)
    for a, b in zip(states, jstates):
        np.testing.assert_allclose(a, b, **JAX_TOL)


@pytest.mark.parametrize("options", list(MORE_OPTIONS))
@pytest.mark.parametrize("opt", list(MORE_OPTIMIZERS))
def test_optimizer_five_steps_match_jax(opt, options):
    name, kwargs = MORE_OPTIMIZERS[opt]
    _close_runs(*_run_both(name, dict(kwargs, **MORE_OPTIONS[options]),
                           "float32", steps=5))


@pytest.mark.parametrize("opt", list(MORE_OPTIMIZERS))
def test_optimizer_multi_precision_fp16_matches_jax(opt):
    """fp16 weights with an fp32 master (the JAX class's convention: the
    base class's (master, state), NAG's and LBSGD's (state, master))."""
    name, kwargs = MORE_OPTIMIZERS[opt]
    got, want = _run_both(name, dict(kwargs, multi_precision=True,
                                     **MORE_OPTIONS["rescale_wd_clip"]),
                          "float16", steps=5)
    assert len(got[1]) == len(want[1]) >= 1
    _close_runs(got, want, weight_tol=FP16_TOL)


def test_sgld_noise_has_the_langevin_variance():
    """SGLD's draws are torch's: with wd 0 the weight after 5 steps is
    w0 - lr/2 * sum of the rescaled gradients plus N(0, 5 lr) noise,
    whose mean and variance are held within 5 standard errors; the
    drift against the JAX class's update with its noise removed."""
    rng = np.random.RandomState(0)
    shape, lr, steps = (200, 50), 0.01, 5
    w0 = rng.uniform(-1, 1, shape).astype(np.float32)
    grads = [rng.uniform(-1, 1, shape).astype(np.float32)
             for _ in range(steps)]
    tmx.random.seed(0)
    upd = topt.get_updater(topt.create("sgld", learning_rate=lr,
                                       rescale_grad=0.5))
    w = torch.from_numpy(w0.copy())
    for g in grads:
        upd(0, torch.from_numpy(g), w)
    drift = w0 - lr / 2 * 0.5 * np.sum(grads, axis=0)
    noise = (w.numpy() - drift).astype(np.float64).ravel()
    n, var = noise.size, steps * lr
    assert abs(noise.mean()) <= 5 * np.sqrt(var / n)
    assert abs(noise.var() - var) <= 5 * var * np.sqrt(2 / n)
    jupd = mx.optimizer.get_updater(mx.optimizer.create(
        "sgld", learning_rate=lr, rescale_grad=0.5))
    jw = mx.nd.array(w0)
    for g in grads:
        jupd(0, mx.nd.array(g), jw)
    jnoise = (jw.asnumpy() - drift).astype(np.float64).ravel()
    assert abs(jnoise.var() - var) <= 5 * var * np.sqrt(2 / n)


UPDATE_OPS = [c for c in __import__("chip_smoke").op_cases()
              if tmx.ops.get_op(c[1]).fn.__module__.endswith("optimizer_ops")
              and not c[1].startswith(("multi_", "sgd_", "mp_sgd_"))]


def _op_steps(pkg, case, steps=5):
    """An update op applied ``steps`` times to the case's weight and
    states, a new gradient each time; every input after, as numpy."""
    import chip_smoke as cs

    ctx = tmx.cpu() if pkg is tmx else mx.cpu()
    arrays = cs.op_case_arrays(case)
    nds = [pkg.nd.array(a.copy(), ctx=ctx, dtype=a.dtype) for a in arrays]
    op = getattr(pkg.nd.op, case[1])
    rng = np.random.RandomState(7)
    for _ in range(steps):
        g = rng.uniform(-1, 1, arrays[1].shape).astype(arrays[1].dtype)
        nds[1] = pkg.nd.array(g, ctx=ctx, dtype=g.dtype)
        op(*nds, out=nds[0], **case[3])
    return [np.asarray(n.asnumpy(), np.float64) for n in nds]


@pytest.mark.parametrize("case", UPDATE_OPS, ids=[c[0] for c in UPDATE_OPS])
def test_update_op_five_steps_match_jax(case):
    """Each update op of the other optimizers (and `adam_update`, now
    registered), its states carried through five steps."""
    got, want = _op_steps(tmx, case), _op_steps(mx, case)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = FP16_TOL if case[2][i][-1] == "float16" else JAX_TOL
        np.testing.assert_allclose(a, b, err_msg=f"input {i}", **tol)


# -- NAG's and Adam's fused updates against their per-parameter ones ---------

def _fused_group_run(pkg, name, kwargs, fused, dtype="float32"):
    """Five updates of `GROUP_SHAPES` NDArray weights through one
    `Updater`, fused or one parameter at a time."""
    rng = np.random.RandomState(0)
    ws = [rng.randn(*s).astype(np.float32) for s in GROUP_SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) * 0.1 for s in GROUP_SHAPES]
          for _ in range(5)]
    prev = os.environ.get("MXNET_FUSED_STEP")
    os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
    try:
        with pkg.cpu():
            o = pkg.optimizer.create(name, **kwargs)
            o.aggregate_num = 0
            upd = pkg.optimizer.get_updater(o)
            weights = [pkg.nd.array(w).astype(dtype) for w in ws]
            for step in gs:
                upd(list(range(len(ws))),
                    [pkg.nd.array(g).astype(dtype) for g in step], weights)
    finally:
        if prev is None:
            os.environ.pop("MXNET_FUSED_STEP", None)
        else:
            os.environ["MXNET_FUSED_STEP"] = prev
    return ([np.asarray(w.asnumpy(), np.float32) for w in weights],
            [x for i in range(len(ws)) for x in _leaves(upd.states[i])])


FUSED_CASES = {
    "adam": ("adam", {"learning_rate": 0.01, "beta1": 0.5, "wd": 1e-3,
                      "rescale_grad": 0.5, "clip_gradient": 0.3}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
                    "rescale_grad": 0.5}),
    "nag_plain": ("nag", {"learning_rate": 0.1, "clip_gradient": 0.05}),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_update_equals_per_parameter_update(case):
    """The port's fused update against its per-parameter update and the
    JAX package's fused and per-parameter ones, 5 steps of 5 weights
    (bounds of `test_aggregated_sgd_matches_sequential`, 1e-6)."""
    name, kwargs = FUSED_CASES[case]
    assert topt.create(name, **kwargs).fused_update_supported
    want = _fused_group_run(tmx, name, kwargs, False)
    for got in (_fused_group_run(tmx, name, kwargs, True),
                _fused_group_run(mx, name, kwargs, True),
                _fused_group_run(mx, name, kwargs, False)):
        assert len(got[1]) == len(want[1])
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,dtype", [("adam", "bfloat16"),
                                        ("nag", "float16")])
def test_fused_multi_precision_equals_per_parameter(name, dtype):
    """Low-precision weights with fp32 masters: the fused update's masters
    and states against the per-parameter update's and the JAX package's;
    the weights each their master rounded."""
    kwargs = dict(FUSED_CASES[name][1], multi_precision=True)
    want = _fused_group_run(tmx, name, kwargs, False, dtype)
    for got in (_fused_group_run(tmx, name, kwargs, True, dtype),
                _fused_group_run(mx, name, kwargs, False, dtype)):
        assert len(got[1]) == len(want[1]) == \
            (2 if name == "nag" else 3) * len(GROUP_SHAPES)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_allclose(a, b, **FP16_TOL)


@torch.no_grad()
def test_adam_fused_update_takes_device_hyperparameters():
    """Adam's bias-corrected rates as a device tensor (what a captured
    step reads at each replay): the float form's results, and the rate
    of each step, not the first step's."""
    from mxnet_tpu_torch.optimizer.optimizer import (fused_hyper_args,
                                                     fused_hyper_slots)

    rng = np.random.RandomState(0)
    shapes = [(6, 5), (5,), (4, 6)]
    w0, g0 = ([rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
              for _ in range(2))
    out = {}
    for form in ("float", "tensor"):
        o = topt.create("adam", learning_rate=0.01, wd=1e-3,
                        clip_gradient=0.3, rescale_grad=0.5)
        ws = [torch.from_numpy(w.copy()) for w in w0]
        gs = [torch.from_numpy(g) for g in g0]
        states = [o.create_state(i, w) for i, w in enumerate(ws)]
        rates = []
        for _ in range(3):
            o._update_count([0, 1, 2])
            lrs, wds = o._fused_hyperparams([0, 1, 2])
            rates.append(lrs[0])
            if form == "float":
                o.fused_update(ws, gs, states, lrs, wds, o.rescale_grad)
            else:
                groups, values = fused_hyper_slots(lrs, wds)
                hyper = torch.tensor(values + [o.rescale_grad])
                o.fused_update(ws, gs, states,
                               *fused_hyper_args(hyper, groups),
                               groups=groups)
        out[form] = ws + [t for s in states for t in s]
        assert len(set(rates)) == 3  # the bias correction moves each step
    for a, b in zip(out["float"], out["tensor"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    o = topt.create("adam")
    assert o._fused_static_key()[-3:] == (0.9, 0.999, 1e-8)


@pytest.mark.parametrize("name", ["adam", "nag"])
def test_module_fit_takes_the_fused_step(name):
    """`Module.fit` on Adam (and NAG) runs `Executor.fused_step`, whose
    trained weights equal the eager decomposition's and the JAX
    package's (`test_fused_step.py:116`'s bounds, rtol 3e-5 / atol
    3e-6)."""
    from test_torch_module import FIT_TOL, INIT, _ctx, _data, _mlp

    params = {"adam": {"learning_rate": 0.01, "beta1": 0.5, "wd": 1e-4},
              "nag": {"learning_rate": 0.1, "momentum": 0.9}}[name]

    def fit(pkg, fused):
        prev = os.environ.get("MXNET_FUSED_STEP")
        os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
        try:
            with _ctx(pkg):
                X, Y = _data()
                m = pkg.mod.Module(_mlp(pkg), context=_ctx(pkg))
                m.fit(pkg.io.NDArrayIter(X, Y, batch_size=8),
                      num_epoch=2, optimizer=name,
                      optimizer_params=tuple(params.items()),
                      arg_params={k: pkg.nd.array(v, ctx=_ctx(pkg))
                                  for k, v in INIT.items()})
                return m, {k: v.asnumpy() for k, v in
                           m.get_params()[0].items()}
        finally:
            if prev is None:
                os.environ.pop("MXNET_FUSED_STEP", None)
            else:
                os.environ["MXNET_FUSED_STEP"] = prev

    m, fused = fit(tmx, True)
    assert m._fused_step_ready()
    assert m._exec._steps.misses == 1 and m._exec._steps.hits == 9
    _, eager = fit(tmx, False)
    _, want = fit(mx, True)
    for k in INIT:
        np.testing.assert_allclose(fused[k], eager[k], err_msg=k, **FIT_TOL)
        np.testing.assert_allclose(fused[k], want[k], err_msg=k, **FIT_TOL)
