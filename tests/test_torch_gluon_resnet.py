"""The slice as a whole: `chip_smoke.gluon_train` (`bench.py:584-652`'s
`_measure_framework` loop, written only against the package it is given)
runs a small model-zoo `ResNetV1(BottleneckV1, ...)` two steps, fp32, on
the JAX package (on the CPU) and on the port (``mx.cpu()``), both from the
weights the JAX package initialized and saved with `save_parameters`. The
losses, the weights and the momenta agree with the JAX package's
hybridized run at rtol 1e-4 / atol 1e-5; the BatchNorm moving stats with
its eager run, since its hybridized run drops them (ROADMAP, "Known
reference-side behaviour"), which the test pins too.
"""
import numpy as np
import torch

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = {"rtol": 1e-4, "atol": 1e-5}
SMALL = cs.GLUON_SMALL


def _batches():
    return cs.gluon_batches(0, SMALL["batch"] * SMALL["batches"],
                            SMALL["size"], SMALL["classes"])


def _jax_weights(path):
    """The JAX package's Xavier weights of the small model, saved."""
    with jmx.cpu():
        net = cs.gluon_small_net(jmx)()
        net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
        net(jmx.nd.zeros((1, 3, SMALL["size"], SMALL["size"])))
        net.save_parameters(path)
    jmx.nd.load(path)  # waits for the JAX package's writer
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _train(pkg, ctx, params_file, **kw):
    data, label = _batches()
    return cs.gluon_state(cs.gluon_train(
        pkg, cs.gluon_small_net(pkg), data, label, dtype="float32",
        batch=SMALL["batch"], epochs=1, ctx=ctx, params_file=params_file,
        **kw))


def test_gluon_train_two_steps_match_jax(tmp_path):
    path = str(tmp_path / "small.params")
    init = _jax_weights(path)
    got = _train(mx, mx.cpu(), path)
    want = _train(jmx, jmx.cpu(), path)
    want_eager = _train(jmx, jmx.cpu(), path, hybridize=False)
    assert len(got["losses"]) == len(want["losses"]) == SMALL["batches"]
    for a, b in zip(got["losses"], want["losses"]):
        np.testing.assert_allclose(a, b, **TOL)
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    assert sorted(got["params"]) == sorted(want["params"]) == sorted(init)
    assert len(stats) == 2 * 9  # the stem, 3 a unit, 1 a shortcut
    for k, v in got["params"].items():
        ref = want_eager if k in stats else want
        np.testing.assert_allclose(v, ref["params"][k], err_msg=k, **TOL)
        assert not np.array_equal(v, init[k]), k  # every array moved
    assert sorted(got["moms"]) == sorted(want["moms"])
    for k, v in got["moms"].items():
        np.testing.assert_allclose(v, want["moms"][k], err_msg=k, **TOL)
    # the reference-side behaviour the port does not follow: the JAX
    # package's hybridized run left every moving stat where it started
    for k in stats:
        np.testing.assert_array_equal(want["params"][k], init[k])


def test_gluon_train_bf16_keeps_fp32_masters(tmp_path):
    """`net.cast("bfloat16")` leaves BatchNorm in bf16 (its cast keeps
    fp32 only for fp16), as in the JAX package; multi-precision SGD keeps
    an fp32 master and momentum for each weight; the steps stay finite."""
    path = str(tmp_path / "small.params")
    _jax_weights(path)
    data, label = _batches()
    run = cs.gluon_train(mx, cs.gluon_small_net(mx), data, label,
                         dtype="bfloat16", batch=SMALL["batch"], epochs=1,
                         ctx=mx.cpu(), params_file=path)
    ref = cs.gluon_small_net(jmx)()
    ref.cast("bfloat16")
    net = run["net"]
    for k, p in net._collect_params_with_prefix().items():
        assert p.data()._data.dtype.is_floating_point
        assert str(p.dtype) == str(ref._collect_params_with_prefix()[k]
                                   .dtype), k
    assert all(np.isfinite(loss.asnumpy()).all() for loss in run["losses"])
    states = run["trainer"]._updater.states
    assert len(states) == len(net.collect_params()) - 18  # no stats
    for mom, master in states.values():
        assert mom.dtype == master.dtype == torch.float32
