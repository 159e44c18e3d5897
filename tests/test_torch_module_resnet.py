"""The slice as a whole: `chip_smoke.module_train` (`bench.py:684-768`'s
`_measure_module` loop, written only against the package it is given)
runs the small symbolic ResNet (`chip_smoke.MODULE_SMALL`: one unit in
each of four stages, the ImageNet stem, 64 x 64 images, batch 4) two steps
on the JAX package (on the CPU) and on the port (``mx.cpu()``), both from
the checkpoint the JAX package saved: its symbol file and its weights.
Each step's outputs, the weights, the BatchNorm moving stats and the
momenta agree at rtol 1e-4 / atol 1e-5 (as `test_torch_gluon_resnet.py`),
with the port's step fused (the function a card captures) and eager.

The weights are the JAX package's Xavier draw after `mx.random.seed(0)`.
At some other draws the bound does not hold for the JAX package against
itself either: its gradient jumps where a max-pool or ReLU switches, and
a weight that differs in the 6th digit after the first step moves the
second step's gradient by ~1 % (ROADMAP, "Known reference-side
behaviour").
"""
import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = {"rtol": 1e-4, "atol": 1e-5}
SMALL = cs.MODULE_SMALL


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX package's small model with Xavier weights, saved as a
    checkpoint; its prefix and the weights as numpy."""
    prefix = str(tmp_path_factory.mktemp("ck") / "small")
    jmx.random.seed(0)
    arg, aux = cs.module_small_init(jmx)
    with jmx.name.NameManager():
        sym = cs.module_small_sym(jmx)()
    jmx.model.save_checkpoint(
        prefix, 0, sym, {k: jmx.nd.array(v) for k, v in arg.items()},
        {k: jmx.nd.array(v) for k, v in aux.items()})
    jmx.nd.load(f"{prefix}-0000.params")  # waits for the JAX writer
    return prefix, arg, aux


def _train(pkg, ctx, prefix, fused):
    sym, arg, aux = pkg.model.load_checkpoint(prefix, 0)
    data, label = cs.module_small_batches(0, 2 * SMALL["batch"])
    return cs.module_state(cs.module_train(
        pkg, lambda: sym, data, label, batch=SMALL["batch"], epochs=1,
        fused=fused, ctx=ctx,
        arg_params={k: v.asnumpy() for k, v in arg.items()},
        aux_params={k: v.asnumpy() for k, v in aux.items()}))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_module_train_two_steps_match_jax(jax_checkpoint, fused):
    prefix, arg, aux = jax_checkpoint
    got = _train(mx, mx.cpu(), prefix, fused)
    want = _train(jmx, jmx.cpu(), prefix, True)
    assert len(got["outputs"]) == len(want["outputs"]) == 2
    for a, b in zip(got["outputs"], want["outputs"]):
        assert a.shape == (SMALL["batch"], SMALL["num_classes"])
        np.testing.assert_allclose(a, b, **TOL)
    init = {**arg, **aux}
    assert sorted(got["params"]) == sorted(want["params"]) == sorted(init)
    fixed = {"bn_data_gamma"}  # fix_gamma: no gradient, no weight decay
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, want["params"][k], err_msg=k, **TOL)
        assert (k in fixed) == np.array_equal(v, init[k]), k
    assert sorted(got["moms"]) == sorted(want["moms"]) == sorted(arg)
    for k, v in got["moms"].items():
        np.testing.assert_allclose(v, want["moms"][k], err_msg=k, **TOL)


def test_small_symbol_and_step_flop_match_jax():
    """The small model's symbol is the JAX package's text, and the FLOP
    count the card's bound comes from reads the same on both."""
    with jmx.name.NameManager():
        want = cs.module_small_sym(jmx)()
    with mx.name.NameManager():
        got = cs.module_small_sym(mx)()
    assert got.tojson() == want.tojson()
    assert cs.module_fixed_params(got) == {"bn_data_gamma"}
    shapes = {"data": (SMALL["batch"],) + SMALL["image_shape"],
              "softmax_label": (SMALL["batch"],)}
    assert cs.symbol_step_flop(got, shapes) == \
        cs.symbol_step_flop(want, shapes) > 0
