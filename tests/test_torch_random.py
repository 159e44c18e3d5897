"""The port's random ops (`mxnet_tpu_torch/ops/random_ops.py`) and the
`nd.random` frontend held to the JAX package's on the CPU. The streams are
torch's, not threefry's, so draws are held by their shape and dtype
(equal to the JAX op's for the same attributes), their moments against
the closed form (`chip_smoke.random_moments`, 10^6 draws after
`mx.random.seed`, so each test is deterministic, within 5 standard
errors), and by exact properties: `shuffle` a permutation, `get_prob` the
draw's log-probability, the zipfian tries the JAX package's Newton solve.
"""
import jax
import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg

CPU = mx.cpu()
RANDOM_CASES = [c for c in cs.op_cases() if c[1] in cs.RANDOM_OPS]


def test_every_random_name_has_a_case():
    want = {n for n in jreg.list_ops() if jreg.get_op(n).fn.__module__
            == "mxnet_tpu.ops.random_ops"}
    assert len(want) == 38
    # and the random image ops (slice 16), held by shape and range too
    image = {n for n in jreg.list_ops() if jreg.get_op(n).needs_rng
             and jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.image_ops"}
    assert len(image) == 16 and image == cs.IMAGE_RANDOM_OPS
    assert {c[1] for c in RANDOM_CASES} == want | image


@pytest.mark.parametrize("case", RANDOM_CASES,
                         ids=[c[0] for c in RANDOM_CASES])
def test_shape_and_dtype_match_jax(case):
    arrays = cs.op_case_arrays(case)
    outs, _, _, _ = cs.port_op_case(mx, case, arrays, CPU)
    op = jreg.get_op(case[1])
    attrs = dict(case[3])
    if not arrays:
        attrs["ctx"] = None
    want = op.fn(jax.random.PRNGKey(0), *arrays, **attrs)
    want = want if isinstance(want, tuple) else (want,)
    assert [(o.shape, o.dtype) for o in outs] == \
        [(tuple(w.shape), np.dtype(w.dtype)) for w in want]


@pytest.mark.parametrize("name", list(cs.RANDOM_MOMENTS))
def test_moments_match_the_closed_form(name):
    mx.random.seed(0)
    got = cs.random_moments(mx, CPU, name)
    mx.random.seed(0)
    assert cs.random_moments(mx, CPU, name) == got  # seeded: repeatable


def test_multinomial_shuffle_and_zipfian_draws():
    mx.random.seed(1)
    cs.random_draw_checks(mx, CPU, n=10 ** 5)


def test_get_prob_is_the_log_probability_of_the_draw():
    p = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    with CPU:
        idx, lp = mx.nd.random.multinomial(mx.nd.array(p), shape=(6,),
                                           get_prob=True)
    idx, lp = idx.asnumpy(), lp.asnumpy()
    assert idx.shape == lp.shape == (2, 6) and idx.dtype == np.int32
    np.testing.assert_allclose(lp, np.log(np.take_along_axis(p, idx, 1)),
                               rtol=1e-6)


def test_shuffle_permutes_rows():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    with CPU:
        out = mx.nd.random.shuffle(mx.nd.array(x)).asnumpy()
    assert sorted(map(tuple, out)) == sorted(map(tuple, x))


@pytest.mark.parametrize("range_max,shape", [(1000, (4, 50)), (50, (8,)),
                                             (7, (2, 3)), (100, (3,))])
def test_zipfian_tries_equal_the_jax_newton_solve(range_max, shape):
    """Where ``n`` draws of ``range_max`` classes take finitely many
    expected tries that are not a whole number. (With n = range_max the
    sum never reaches n: the 25 Newton steps creep towards infinity, and
    where they stop depends on how each backend rounds 1 - (1-p)^t; with
    n = 1 the solve is exactly 1 try, and its ceiling is 1 or 2 by the
    last bit of the sum.)"""
    with CPU:
        samples, tries = mx.nd.op._sample_unique_zipfian(
            range_max=range_max, shape=shape)
    jsamples, jtries = jmx.nd.op._sample_unique_zipfian(
        range_max=range_max, shape=shape)
    assert samples.shape == jsamples.shape and samples.dtype == np.int32
    np.testing.assert_array_equal(tries.asnumpy(), jtries.asnumpy())
    rows = samples.asnumpy().reshape(-1, shape[-1])
    assert all(len(set(r)) == shape[-1] for r in rows)


def test_frontend_routes_numbers_and_arrays_like_mxnet():
    """Numbers take ``_random_x`` (the JAX frontend's ``random.x``);
    arrays one distribution a row, ``_sample_x`` (the JAX package's
    ``random.sample_x``); a mix raises."""
    mx.random.seed(3)
    with CPU:
        got = mx.nd.random.normal(0, 1, shape=(2, 3))
        want = jmx.nd.random.normal(0, 1, shape=(2, 3))
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        mu = np.array([0.0, 100.0], np.float32)
        sigma = np.array([1.0, 0.01], np.float32)
        rows = mx.nd.random.normal(mx.nd.array(mu), scale=mx.nd.array(sigma),
                                   shape=(50,))
        want = jmx.nd.random.sample_normal(jmx.nd.array(mu),
                                           jmx.nd.array(sigma), shape=(50,))
        assert (rows.shape, rows.dtype) == (want.shape, want.dtype)
        assert abs(rows.asnumpy()[1].mean() - 100.0) < 0.01
        for name in ("uniform", "gamma", "exponential", "poisson",
                     "negative_binomial", "generalized_negative_binomial"):
            assert getattr(mx.nd.random, "sample_" + name) is not None
        assert mx.nd.uniform(shape=(2,)).shape == (2,)  # the legacy names
        assert mx.nd.random.randint(0, 4, shape=(3,)).dtype == np.int32
        with pytest.raises(mx.base.MXNetError, match="all be arrays"):
            mx.nd.random.normal(mx.nd.array(mu), 1.0)
    sym = mx.sym.random.normal(mx.sym.var("mu"), mx.sym.var("sigma"),
                               shape=(4,))
    assert sym.list_arguments() == ["mu", "sigma"]
    ex = sym.simple_bind(CPU, mu=(2,), sigma=(2,))
    out = ex.forward(mu=mx.nd.array(mu, ctx=CPU),
                     sigma=mx.nd.array(sigma, ctx=CPU))[0]
    assert out.shape == (2, 4)


def test_seed_repeats_draws():
    def draws():
        with CPU:
            return [mx.nd.random.uniform(shape=(5,)).asnumpy(),
                    mx.nd.random.poisson(4.0, shape=(5,)).asnumpy(),
                    mx.nd.random.shuffle(mx.nd.arange(8)).asnumpy()]

    mx.random.seed(42)
    first = draws()
    assert not np.array_equal(first[0], draws()[0])  # the stream moves on
    mx.random.seed(42)
    for a, b in zip(first, draws()):
        np.testing.assert_array_equal(a, b)


def test_random_ops_inside_a_hybridized_block():
    """Every random op in a hybridized block (on a card, inside its
    captured graph): fresh draws at each call, an eager call's shapes,
    ``shuffle`` a permutation, the zipfian tries an eager call's."""
    assert cs.random_in_graph(mx, CPU) == 19


IMAGE_CASES = [c for c in RANDOM_CASES if c[1] in cs.IMAGE_RANDOM_OPS]


@pytest.mark.parametrize("case", IMAGE_CASES,
                         ids=[c[0] for c in IMAGE_CASES])
def test_random_image_ops_stay_in_their_range(case):
    """Each random image op (slice 16), over a few seeds, gives an output
    its transform can reach from the input (`image_random_in_range`)."""
    for seed in range(4):
        mx.random.seed(seed)
        cs.image_random_in_range(case, cs.port_op_case(
            mx, case, cs.op_case_arrays(case), CPU))
