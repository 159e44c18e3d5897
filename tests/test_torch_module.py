"""The port's Module API (`mxnet_tpu_torch.module`, `model`'s checkpoints,
`callback`, gluon's `export` and `SymbolBlock`) held to the JAX package's
on the CPU, from the same numpy inputs and initial weights.

Bounds: trained weights within `test_fused_step.py:116`'s rtol 3e-5 /
atol 3e-6, for the port against the JAX package and for the port's fused
step against its eager decomposition; forwards of a checkpoint and of an
exported block within `test_module.py:176-216`'s atol 1e-5.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.compile_cache import named_stats

CPU = mx.cpu()
FIT_TOL = {"rtol": 3e-5, "atol": 3e-6}
FWD_TOL = {"rtol": 0, "atol": 1e-5}

SGD_MOM = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
SGD = {"learning_rate": 0.05}


def _ctx(pkg):
    return CPU if pkg is mx else jmx.cpu()


def _mlp(pkg):
    with pkg.name.NameManager():
        data = pkg.sym.Variable("data")
        fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
        act = pkg.sym.Activation(fc1, act_type="relu")
        fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name="fc2")
        return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _data(n=40, dim=8, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, dim)).astype(np.float32),
            rng.randint(0, classes, (n,)).astype(np.float32))


def _jax_init():
    """The JAX package's initial weights of the MLP (Xavier, gaussian,
    magnitude 2, as `test_fused_step.py` draws them), as numpy."""
    jmx.random.seed(7)
    m = jmx.mod.Module(_mlp(jmx), context=jmx.cpu())
    m.bind(data_shapes=[("data", (8, 8))],
           label_shapes=[("softmax_label", (8,))])
    m.init_params(jmx.init.Xavier(rnd_type="gaussian", magnitude=2))
    arg, _ = m.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


INIT = _jax_init()


class _ShortLastBatchIter:
    """Full batches, then one SHORT final batch (no padding by the
    iterator): Module's pad-up path must absorb it."""

    def __init__(self, pkg, X, Y, batch_size):
        self.pkg, self.X, self.Y, self.batch_size = pkg, X, Y, batch_size
        self.cursor = 0

    @property
    def provide_data(self):
        return [self.pkg.io.DataDesc("data", (self.batch_size,)
                                     + self.X.shape[1:])]

    @property
    def provide_label(self):
        return [self.pkg.io.DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self.cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.cursor >= len(self.X):
            raise StopIteration
        end = min(self.cursor + self.batch_size, len(self.X))
        ctx = _ctx(self.pkg)
        b = self.pkg.io.DataBatch(
            data=[self.pkg.nd.array(self.X[self.cursor:end], ctx=ctx)],
            label=[self.pkg.nd.array(self.Y[self.cursor:end], ctx=ctx)],
            pad=0)
        self.cursor = end
        return b


def _fit(pkg, params, *, fused=True, num_epoch=2, it=None, **fit_kw):
    """`test_fused_step.py`'s `_fit`: 2 epochs x 5 steps of the MLP from
    `INIT`; the module and its trained weights."""
    os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
    try:
        with _ctx(pkg):
            X, Y = _data()
            it = it(pkg) if it else pkg.io.NDArrayIter(X, Y, batch_size=8,
                                                       shuffle=False)
            m = pkg.mod.Module(_mlp(pkg), context=_ctx(pkg))
            opt = dict(params)
            if "lr_scheduler" in opt:
                opt["lr_scheduler"] = opt["lr_scheduler"](pkg)
            m.fit(it, num_epoch=num_epoch, optimizer="sgd",
                  optimizer_params=tuple(opt.items()),
                  arg_params={k: pkg.nd.array(v, ctx=_ctx(pkg))
                              for k, v in INIT.items()}, **fit_kw)
            arg, _ = m.get_params()
            return m, {k: v.asnumpy() for k, v in arg.items()}
    finally:
        os.environ.pop("MXNET_FUSED_STEP", None)


def _close(got, want, tol=FIT_TOL):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _sched(pkg):
    return pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)


@pytest.mark.parametrize("params", [SGD_MOM, SGD], ids=["momentum", "plain"])
def test_fit_matches_jax(params):
    _, want = _fit(jmx, params)
    _, got = _fit(mx, params)
    _close(got, want)
    assert any(not np.allclose(got[k], INIT[k]) for k in got)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_fit_over_float64_sources_binds_float32(fused):
    """float64 sources (`bench.py`'s overlap MLP): `NDArrayIter` cuts
    float32 batches and now says so in `provide_data`, so `fit` binds
    float32 inputs and trains as the JAX package does (ROADMAP C.6: the
    parent port bound float64 inputs beside float32 weights and raised)."""
    def float64_iter(pkg):
        X, Y = _data()
        return pkg.io.NDArrayIter(X.astype(np.float64), Y.astype(np.float64),
                                  batch_size=8, shuffle=False)

    m, got = _fit(mx, SGD_MOM, fused=fused, it=float64_iter)
    _, want = _fit(jmx, SGD_MOM, it=float64_iter)
    assert m._exec.arg_dict["data"].dtype == np.float32
    _close(got, want)


@pytest.mark.parametrize("params", [
    SGD_MOM, SGD, dict(SGD_MOM, lr_scheduler=_sched),
    dict(SGD_MOM, clip_gradient=0.05, rescale_grad=0.5)],
    ids=["momentum", "plain", "factor_scheduler", "clip"])
def test_fused_step_matches_eager(params):
    m, fused = _fit(mx, params)
    _, eager = _fit(mx, params, fused=False)
    _close(fused, eager)
    if "lr_scheduler" in params:
        # 10 updates: the rate halved at 3, 5, 7 and 9
        opt = m._optimizer
        assert opt.num_update == 10
        assert opt.lr_scheduler(opt.num_update) == pytest.approx(0.1 / 16)
        _, want = _fit(jmx, params)
        _close(fused, want)


def test_short_last_batch_pads_into_the_same_step():
    """20 rows at batch 8: the last batch of 4 rows is padded up to 8 and
    runs the step already built; outputs come back sliced to 4 rows. The
    padded rows train, as in the JAX package."""
    X, Y = _data(n=20)
    before = named_stats("executor")["misses"]
    m, got = _fit(mx, SGD_MOM, it=lambda p: _ShortLastBatchIter(p, X, Y, 8))
    assert named_stats("executor")["misses"] - before == 1
    assert m.get_outputs()[0].shape == (4, 4)
    _, want = _fit(jmx, SGD_MOM,
                   it=lambda p: _ShortLastBatchIter(p, X, Y, 8))
    _close(got, want)


def test_predict_and_score_match_jax():
    X, Y = _data(n=20, seed=3)

    def run(pkg):
        m, _ = _fit(pkg, SGD_MOM, num_epoch=1)
        with _ctx(pkg):
            it = pkg.io.NDArrayIter(X, Y, batch_size=8)
            pred = m.predict(it)
            per_batch = m.predict(it, merge_batches=False)
            score = m.score(it, "acc")
        return pred.asnumpy(), [b[0].shape for b in per_batch], score

    got, want = run(mx), run(jmx)
    assert got[0].shape == (20, 4)  # merged, the pad sliced off
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    assert got[1] == want[1] == [(8, 4), (8, 4), (4, 4)]
    assert got[2] == want[2]


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, saver):
    """A checkpoint written by either package loads in the other
    (`Module.load`) and gives the same forward, and the symbol file is the
    same text."""
    src, dst = (jmx, mx) if saver == "jax" else (mx, jmx)
    prefix = str(tmp_path / "mlp")
    m, _ = _fit(src, SGD_MOM, num_epoch=1)
    m.save_checkpoint(prefix, 3)
    if src is jmx:
        jmx.nd.load(f"{prefix}-0003.params")  # waits for the writer
    X, Y = _data(n=8, seed=5)

    def forward(pkg, mod):
        with _ctx(pkg):
            mod.forward(pkg.io.DataBatch([pkg.nd.array(X)],
                                         [pkg.nd.array(Y)]), is_train=False)
            return mod.get_outputs()[0].asnumpy()

    loaded = dst.mod.Module.load(prefix, 3, context=_ctx(dst))
    loaded.bind(data_shapes=[("data", (8, 8))],
                label_shapes=[("softmax_label", (8,))], for_training=False)
    assert loaded.symbol.tojson() == m.symbol.tojson()
    np.testing.assert_allclose(forward(dst, loaded), forward(src, m),
                               **FWD_TOL)


def test_checkpoint_latest_fallback_and_keep(tmp_path, monkeypatch):
    prefix = str(tmp_path / "ck")
    m, _ = _fit(mx, SGD, num_epoch=1)
    arg, aux = m.get_params()
    for epoch in (1, 2, 3):
        mx.model.save_checkpoint(prefix, epoch, m.symbol, arg, aux)
    assert mx.model.list_checkpoint_epochs(prefix) == [1, 2, 3]
    with open(f"{prefix}-0003.params", "r+b") as f:  # tear the newest
        f.seek(40)
        f.write(b"\xff" * 8)
    sym, args, _, epoch = mx.model.load_checkpoint(prefix, return_epoch=True)
    assert epoch == 2 and sym.tojson() == m.symbol.tojson()
    np.testing.assert_array_equal(args["fc1_weight"].asnumpy(),
                                  arg["fc1_weight"].asnumpy())
    with pytest.raises(MXNetError):
        mx.model.load_checkpoint(prefix, 3)
    monkeypatch.setenv("MXNET_CHECKPOINT_KEEP", "2")
    mx.model.save_checkpoint(prefix, 4, m.symbol, arg, aux)
    assert mx.model.list_checkpoint_epochs(prefix) == [3, 4]
    assert mx.model.find_latest_checkpoint(prefix) == 4


def test_optimizer_states_round_trip(tmp_path):
    prefix = str(tmp_path / "st")
    m, _ = _fit(mx, SGD_MOM, num_epoch=1)
    m.save_checkpoint(prefix, 1, save_optimizer_states=True)
    want = {i: s.clone() for i, s in m._updater.states.items()}
    loaded = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                context=CPU)
    loaded.bind(data_shapes=[("data", (8, 8))],
                label_shapes=[("softmax_label", (8,))])
    loaded.init_optimizer(optimizer="sgd",
                          optimizer_params=tuple(SGD_MOM.items()))
    got = loaded._updater.states
    assert sorted(got) == sorted(want) and len(want) == 4
    for i, s in want.items():
        torch.testing.assert_close(got[i], s, rtol=0, atol=0)


def test_export_crosses_packages_with_symbol_block(tmp_path):
    """`test_module.py:176-216` across the packages: a hybridized gluon net
    with BatchNorm exported by one package, imported with
    `SymbolBlock.imports` by the other."""
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)

    def net(pkg):
        nn = pkg.gluon.nn
        n = nn.HybridSequential(prefix="n_")
        with n.name_scope():
            n.add(nn.Dense(8, activation="relu"), nn.BatchNorm(),
                  nn.Dense(4))
        return n

    outs, files = {}, {}
    for pkg in (mx, jmx):
        with _ctx(pkg):
            n = net(pkg)
            n.initialize(pkg.init.Xavier(), ctx=_ctx(pkg))
            n.hybridize()
            outs[pkg] = n(pkg.nd.array(x)).asnumpy()
            prefix = str(tmp_path / pkg.__name__)
            sym = n.export(prefix, 7)
            assert sym.list_auxiliary_states()
            files[pkg] = prefix
    jmx.nd.load(files[jmx] + "-0007.params")  # waits for the writer
    for src, dst in ((mx, jmx), (jmx, mx)):
        with _ctx(dst):
            block = dst.gluon.SymbolBlock.imports(
                files[src] + "-symbol.json", ["data"],
                files[src] + "-0007.params", ctx=_ctx(dst))
            got = block(dst.nd.array(x)).asnumpy()
        np.testing.assert_allclose(got, outs[src], **FWD_TOL)
    with open(files[mx] + "-symbol.json") as a, \
            open(files[jmx] + "-symbol.json") as b:
        assert a.read() == b.read()


def test_symbol_block_trains_and_hybridizes():
    """A SymbolBlock's parameters take gradients, and hybridized it gives
    the eager outputs."""
    with CPU:
        block = mx.gluon.SymbolBlock(_mlp(mx).get_internals()["fc2_output"],
                                     mx.sym.var("data"))
        block.initialize(mx.init.Xavier(), ctx=CPU)
        x = mx.nd.array(_data(n=4)[0])
        eager = block(x).asnumpy()
        with mx.autograd.record():
            y = block(x)
        y.backward()
        grads = {k: p.grad().asnumpy()
                 for k, p in block.collect_params().items()}
        block.hybridize()
        np.testing.assert_allclose(block(x).asnumpy(), eager, **FWD_TOL)
    assert sorted(grads) == ["fc1_bias", "fc1_weight", "fc2_bias",
                             "fc2_weight"]
    assert all(np.abs(g).sum() > 0 for g in grads.values())


def test_fused_step_gate_declines_like_jax(monkeypatch):
    def module(**bind_kw):
        m = mx.mod.Module(_mlp(mx), context=CPU)
        m.bind(data_shapes=[("data", (8, 8))],
               label_shapes=[("softmax_label", (8,))], **bind_kw)
        m.init_params(mx.init.Xavier())
        m.init_optimizer(optimizer="sgd",
                         optimizer_params=tuple(SGD_MOM.items()))
        return m

    assert module()._fused_step_ready()
    assert not module(grad_req="add")._fused_step_ready()
    assert not module(inputs_need_grad=True)._fused_step_ready()
    m = module()
    m.install_monitor(mx.monitor.Monitor(1))
    assert not m._fused_step_ready()
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    assert not module()._fused_step_ready()
    monkeypatch.delenv("MXNET_FUSED_STEP")
    m = module()
    with pytest.raises(NotImplementedError, match="zero1"):
        m._exec.fused_step(m._optimizer, m._updater, m._param_names,
                           zero1=object())
    # as_predictor serves the module's weights (it raised before the
    # serving stack was ported)
    out = m.as_predictor(buckets=(8,)).predict(np.zeros((2, 8), np.float32))
    assert out.shape == (2, 4)


def test_fused_step_leaves_counts_after_a_failure():
    """A step that raises leaves the optimizer's update counts as they
    were, as the JAX package's does before any buffer was consumed."""
    m = mx.mod.Module(_mlp(mx), context=CPU)
    m.bind(data_shapes=[("data", (8, 8))],
           label_shapes=[("softmax_label", (8,))])
    m.init_params(mx.init.Xavier())
    m.init_optimizer(optimizer="sgd", optimizer_params=tuple(SGD.items()))
    X, Y = _data(n=8)
    batch = mx.io.DataBatch([mx.nd.array(X, ctx=CPU)],
                            [mx.nd.array(Y, ctx=CPU)])
    assert m.fused_step(batch) and m._optimizer.num_update == 1
    m._exec.arg_dict["fc1_weight"]._data = torch.zeros(3)  # broken shape
    with pytest.raises(RuntimeError):
        m.fused_step(batch)
    assert m._optimizer.num_update == 1
    assert m._optimizer._index_update_count == {i: 1 for i in range(4)}


def test_module_without_a_card_needs_the_cpu():
    if mx.num_gpus():
        pytest.fail("this test expects a machine without a CUDA card")
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.mod.Module(_mlp(mx))
    with CPU:
        m = mx.mod.Module(_mlp(mx))
    m.bind(data_shapes=[("data", (8, 8))],
           label_shapes=[("softmax_label", (8,))])
    assert m._exec._device.type == "cpu"


def test_params_are_written_in_place():
    """init_params, set_params and copy_params_from write into the bound
    tensors; get_params returns copies."""
    m = mx.mod.Module(_mlp(mx), context=CPU)
    m.bind(data_shapes=[("data", (8, 8))],
           label_shapes=[("softmax_label", (8,))])
    m.init_params(mx.init.Xavier())
    bound = {k: v._data for k, v in m._exec.arg_dict.items()}
    arg, aux = m.get_params()
    assert arg["fc1_weight"]._data is not bound["fc1_weight"]
    m.set_params({k: v * 0 + 1 for k, v in arg.items()}, aux)
    m._exec.copy_params_from({"fc2_bias": np.full(4, 2.0, np.float32)})
    for k, t in bound.items():
        assert m._exec.arg_dict[k]._data is t
    assert float(bound["fc1_weight"].sum()) == 16 * 8
    assert float(bound["fc2_bias"].sum()) == 8


def test_callbacks_run(tmp_path, caplog):
    prefix = str(tmp_path / "cb")
    seen = []
    with caplog.at_level("INFO"):
        _fit(mx, SGD, num_epoch=2, epoch_end_callback=[
            mx.callback.do_checkpoint(prefix),
            lambda epoch, sym, arg, aux: seen.append(epoch)],
            batch_end_callback=[mx.callback.Speedometer(8, frequent=2),
                                mx.callback.log_train_metric(2),
                                mx.callback.ProgressBar(5)])
    assert seen == [0, 1]
    assert mx.model.list_checkpoint_epochs(prefix) == [1, 2]
    assert any("samples/sec" in r.message for r in caplog.records)


@torch.no_grad()
def test_sgd_fused_update_takes_device_hyperparameters():
    """The tensor form of `SGD.fused_update` (what a captured step reads),
    laid out by `fused_hyper_slots` with one slot for the weights that
    share (lr, wd), gives the float form's results."""
    from mxnet_tpu_torch.optimizer.optimizer import (fused_hyper_args,
                                                     fused_hyper_slots)

    rng = np.random.RandomState(0)
    shapes = [(6, 5), (5,), (4, 6), (3,)]
    w0, g0 = ([rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
              for _ in range(2))
    lrs, wds = [0.1, 0.1, 0.05, 0.1], [1e-4, 0.0, 1e-4, 1e-4]
    groups, values = fused_hyper_slots(lrs, wds)
    assert groups == (0, 1, 2, 0)
    assert values == [0.1, 0.1, 0.05, 1e-4, 0.0, 1e-4]
    out = {}
    for form in ("float", "tensor"):
        o = mx.optimizer.SGD(momentum=0.9, clip_gradient=0.3,
                             rescale_grad=0.5)
        ws = [torch.from_numpy(w.copy()) for w in w0]
        gs = [torch.from_numpy(g) for g in g0]
        states = [o.create_state(i, w) for i, w in enumerate(ws)]
        for _ in range(3):
            if form == "float":
                o.fused_update(ws, gs, states, lrs, wds, o.rescale_grad)
            else:
                hyper = torch.tensor(values + [o.rescale_grad])
                o.fused_update(ws, gs, states,
                               *fused_hyper_args(hyper, groups),
                               groups=groups)
        out[form] = ws + states
    for a, b in zip(out["float"], out["tensor"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
