"""`mx.rnn` (`encode_sentences`, `BucketSentenceIter`) and
`mx.mod.BucketingModule` of the port held to the JAX package's on the CPU:
the same encodings and the same padded batches and bucket keys from the
same seeds, and the bucketed LSTM LM of `example/rnn/lstm_bucketing.py`'s
``sym_gen`` (`chip_smoke.bucketing_sym_gen`) stepped over two buckets from
the same weights: each step's outputs and the parameters after agree
within rtol 1e-4 / atol 1e-5, by the eager ``forward_backward`` +
``update`` and by the port's fused step. Every bucket's module shares the
default bucket's parameter arrays and optimizer.
"""
import random

import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = {"rtol": 1e-4, "atol": 1e-5}
CFG = {"layers": 2, "hidden": 8, "embed": 6, "vocab": 30, "batch": 4}
BUCKETS = [5, 8]


def _sentences():
    rng = np.random.RandomState(3)
    return [[int(v) for v in rng.randint(1, CFG["vocab"],
                                         size=rng.choice([3, 4, 5, 7, 8]))]
            for _ in range(40)]


def test_encode_sentences_matches_jax():
    words = [["the", "cat", "sat"], ["the", "dog"], ["a", "cat", "ran"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 1}):
        assert mx.rnn.encode_sentences(words, **kw) == \
            jmx.rnn.encode_sentences(words, **kw)
    vocab = {"\n": -1, "the": 0, "cat": 1, "<unk>": 2}
    got = mx.rnn.encode_sentences([["the", "cow"]], vocab=dict(vocab),
                                  unknown_token="<unk>")
    assert got == jmx.rnn.encode_sentences([["the", "cow"]],
                                           vocab=dict(vocab),
                                           unknown_token="<unk>")
    assert got[0] == [[0, 2]]


def _batches(pkg, layout, buckets):
    random.seed(1)
    np.random.seed(1)
    it = pkg.rnn.BucketSentenceIter(_sentences(), CFG["batch"],
                                    buckets=buckets, invalid_label=0,
                                    layout=layout)
    out = [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
            b.provide_data[0].shape) for b in it]
    return it, out


@pytest.mark.parametrize("layout,buckets", [("NT", BUCKETS), ("TN", BUCKETS),
                                            ("NT", None)],
                         ids=["NT", "TN", "default_buckets"])
def test_bucket_sentence_iter_matches_jax(layout, buckets):
    with mx.cpu():
        it, got = _batches(mx, layout, list(buckets) if buckets else None)
    ref, want = _batches(jmx, layout, list(buckets) if buckets else None)
    assert it.buckets == ref.buckets
    assert it.default_bucket_key == ref.default_bucket_key
    assert [(d.name, d.shape) for d in it.provide_data] == \
        [(d.name, d.shape) for d in ref.provide_data]
    assert len(got) == len(want) > 0
    for (k, d, l, s), (wk, wd, wl, ws) in zip(got, want):
        assert (k, s) == (wk, ws)
        np.testing.assert_array_equal(d, wd)
        np.testing.assert_array_equal(l, wl)


def _module_run(pkg, ctx, fused):
    random.seed(0)
    np.random.seed(0)
    it = pkg.rnn.BucketSentenceIter(_sentences(), CFG["batch"],
                                    buckets=list(BUCKETS), invalid_label=0)
    gen = cs.bucketing_sym_gen(pkg, CFG)

    def sym_gen(key):
        with pkg.name.NameManager():
            return gen(key)

    mod = pkg.mod.BucketingModule(sym_gen,
                                  default_bucket_key=it.default_bucket_key,
                                  context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    sym = sym_gen(max(BUCKETS))[0]
    shapes = dict(zip(sym.list_arguments(), sym.infer_shape(
        data=(CFG["batch"], max(BUCKETS)),
        softmax_label=(CFG["batch"], max(BUCKETS)))[0]))
    rng = np.random.RandomState(2)
    init = {n: rng.uniform(-0.2, 0.2, shapes[n]).astype(np.float32)
            for n in sym.list_arguments()
            if n not in ("data", "softmax_label")}
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in init.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.5, "momentum": 0.9})
    keys, outs = [], []
    batches = list(it)
    # two steps in each bucket, alternating
    order = [next(b for b in batches if b.bucket_key == k)
             for k in (8, 5)] * 2
    for b in order:
        if fused:
            assert mod.fused_step(b)
        else:
            mod.forward_backward(b)
            mod.update()
        keys.append(b.bucket_key)
        outs.append(mod.get_outputs()[0].asnumpy())
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return mod, keys, outs, params


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused_step"])
def test_bucketing_module_matches_jax(fused):
    with mx.cpu():
        mod, keys, outs, params = _module_run(mx, mx.cpu(), fused)
    _, want_keys, want_outs, want_params = _module_run(jmx, jmx.cpu(),
                                                       False)
    assert keys == want_keys == [8, 5, 8, 5]
    for g, w in zip(outs, want_outs):
        np.testing.assert_allclose(g, w, **TOL)
    assert sorted(params) == sorted(want_params)
    for k in want_params:
        np.testing.assert_allclose(params[k], want_params[k], err_msg=k,
                                   **TOL)
    # one storage and one optimizer for every bucket
    default = mod._buckets[mod.default_bucket_key]
    other = mod._buckets[5]
    for name in default._param_names:
        assert other._exec.arg_dict[name] is default._exec.arg_dict[name]
    assert other._updater is default._updater
    assert sorted(mod._buckets) == BUCKETS
