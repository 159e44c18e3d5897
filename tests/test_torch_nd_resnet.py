"""The slice as a whole: `chip_smoke.resnet50_v1_nd`, written only against
the package it is given, steps twice on the JAX package (on the CPU) and on
the port (``mx.cpu()``) from the same numpy weights and batch. The losses,
the gradients, the weights, the momenta and the BatchNorm moving stats
agree at rtol 1e-4 / atol 1e-5."""
import numpy as np
import torch

import chip_smoke as cs
import mxnet_tpu
import mxnet_tpu_torch

TOL = {"rtol": 1e-4, "atol": 1e-5}
SMALL = cs.ND_SMALL
ARCH = {"units": SMALL["units"], "widths": SMALL["widths"]}


def two_steps(mx):
    params, aux = cs.resnet50_v1_init(0, classes=SMALL["classes"], **ARCH)
    x, label = cs.resnet50_v1_batch(1, SMALL["batch"], SMALL["size"],
                                    SMALL["classes"])
    ps, moms, auxs, xs, labels = cs.resnet50_v1_arrays(
        mx, mx.cpu(), params, aux, x, label)
    losses = [float(cs.resnet50_v1_nd_step(mx, ps, moms, auxs, xs, labels,
                                           **ARCH).asscalar())
              for _ in range(2)]
    state = {"loss": np.asarray(losses)}
    for group, arrays in (("param", ps), ("mom", moms), ("aux", auxs)):
        state.update({f"{group} {k}": v.asnumpy() for k, v in arrays.items()})
    state.update({f"grad {k}": v.grad.asnumpy() for k, v in ps.items()})
    return state, params, aux


def test_resnet50_v1_nd_two_steps_match_jax():
    got, params, aux = two_steps(mxnet_tpu_torch)
    want, _, _ = two_steps(mxnet_tpu)
    assert sorted(got) == sorted(want)
    assert len(got) == 1 + 3 * len(params) + len(aux)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # the steps trained: every moving stat moved, every weight changed
    for k, v in aux.items():
        assert not np.allclose(got[f"aux {k}"], v), k
    for k, v in params.items():
        assert not np.array_equal(got[f"param {k}"], v), k


def test_flop_count_of_the_full_width_step():
    """The forward's multiply-adds x 2 at batch 32, 224 x 224, counted from
    the convolution and FullyConnected shapes: ResNet-50 v1's (stride on
    the first 1x1) 3.86 GMAC an image."""
    mx = mxnet_tpu_torch
    params, aux = cs.resnet50_v1_shapes()
    assert len(params) == 161 + 32  # gluon's, with the 1x1 convs' biases
    meta = {k: mx.nd.NDArray(torch.empty(v, device="meta"))
            for k, v in {**params, **aux}.items()}
    flop = []
    x = mx.nd.NDArray(torch.empty((1, 3, cs.ND_SIZE, cs.ND_SIZE),
                                  device="meta"))
    label = mx.nd.NDArray(torch.empty((1,), device="meta"))
    cs.resnet50_v1_nd(mx, {k: meta[k] for k in params},
                      {k: meta[k] for k in aux}, x, label, flop=flop)
    assert len(flop) == 53 + 1
    assert sum(flop) == 7715946496
