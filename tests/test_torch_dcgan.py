"""Slice 13's path on the CPU: `chip_smoke.dcgan_nets` (the repo example's
DCGAN) at the example's widths, batch 8, two D/G iterations of the
example's loop on both packages from the same numpy weights, images and
noise; and the example itself run through the port with only its imports
changed.

Bounds: the JAX package's rtol 1e-4 / atol 1e-6 (`mxnet_tpu/test_utils.py:
142-160`) for the losses, every weight and both Adam moments. The
reference is the JAX nets un-hybridized: a hybridized JAX block drops
BatchNorm's moving-stat updates (ROADMAP.md, reference-side behaviour),
and the port's hybridized nets write them as MXNet does, so the moving
stats are held to the un-hybridized JAX nets, whose other values equal
the hybridized ones'.
"""
import numpy as np

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = {"rtol": 1e-4, "atol": 1e-6}


def test_small_dcgan_matches_jax():
    got_losses, got = cs.dcgan_small_run(mx, mx.cpu())
    want_losses, want = cs.dcgan_small_run(jmx, jmx.cpu(), hybridize=False)
    for g, w in zip(got_losses, want_losses):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)
    assert sorted(got) == sorted(want)
    assert any("running_mean" in k for k in got)
    assert any("adam var" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # the nets trained, and every moving stat moved
    _, before = cs.dcgan_small_run(mx, mx.cpu(), cfg=dict(cs.GAN_SMALL,
                                                          iters=0))
    assert all(not np.array_equal(got[k], before[k]) for k in got
               if "running" in k or "weight" in k)


def test_nets_follow_the_published_ladder():
    """At 16 the example's three layers; at 64 the published 4-8-16-32-64
    generator at widths ngf*8 .. ngf, nc, and its mirror."""
    for size, n_convs in ((16, 3), (64, 5)):
        g, d = cs.dcgan_nets(mx, 100, 64, 64, 3, size)
        with mx.cpu():
            for net in (g, d):
                net.initialize(ctx=mx.cpu())
            img = g(mx.nd.zeros((2, 100, 1, 1)))
            assert img.shape == (2, 3, size, size)
            assert d(img).shape == (2, 1, 1, 1)
        convs = [b for b in g._children.values()
                 if isinstance(b, mx.gluon.nn.Conv2DTranspose)]
        assert len(convs) == n_convs
        if size == 64:
            assert [c._channels for c in convs] == [512, 256, 128, 64, 3]
    flop, g_flop, d_flop = cs.dcgan_flop(cs.GAN_FULL)
    assert flop == 9 * d_flop + 4 * g_flop


def test_example_runs_through_the_port():
    """`example/gluon/dcgan.py` at its defaults with only its imports
    changed: after 3 epochs the discriminator separates real from fake by
    more than the JAX package's own margin (`test_examples.py:114-121`)."""
    figures = cs.run_dcgan_example([], ctx=mx.cpu())
    assert figures["d-real-minus-fake"] > cs.GAN_MARGIN, figures
    assert set(figures) == {"blob-minus-border", "d-real-minus-fake"}
