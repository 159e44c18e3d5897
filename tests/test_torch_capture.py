"""Every CUDA-graph capture of the port runs with Python's cyclic collector
held off (`compile_cache.capture`, under `collector_held`): `GraphProgram`
(the generation engine's programs), `CachedOp` (hybridize), the Module's
training step and the inference forward of a ``grad_req="null"``
executor, each serving bucket's (`symbol/executor.py`). A collection during a capture can destroy a dead
program's graph, which invalidates the capture (`PERF.md` §6).

There is no card here, so `torch.cuda`'s stream and graph calls are
replaced by stand-ins: the stand-in ``torch.cuda.graph`` records whether
the collector was on when the capture began and runs its body eagerly.
The Module step's warm-up runs are undone before its capture, so with the
stand-in its moving stats move once; arrays rebound since the capture are
copied into the captured tensors and bound to them again.
"""
import contextlib
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _cached_op, compile_cache
from mxnet_tpu_torch.symbol import executor as executor_mod

CPU = mx.cpu()


class _Graph:
    def __init__(self):
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        pass


class _Stream:
    def __init__(self, *args, **kwargs):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def captures(monkeypatch):
    """Stand-ins for the CUDA calls of a capture; the list of
    ``gc.isenabled()`` at the start of each capture."""
    seen = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode=None):
        seen.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    assert gc.isenabled()
    yield seen
    assert gc.isenabled()  # the collector is back on after each capture


def test_graph_program_captures_with_the_collector_off(captures):
    prog = compile_cache.GraphProgram(lambda x: (x + 1,), [(3,)], "cpu")
    prog._capture()
    assert captures == [False]
    assert prog.captures == 1


@pytest.mark.parametrize("recording", [False, True])
def test_cached_op_captures_with_the_collector_off(captures, recording):
    w = mx.nd.ones((3,), ctx=CPU)
    x = mx.nd.array(np.arange(3.0), ctx=CPU)
    if recording:
        w.attach_grad()
    prog = _cached_op._GraphProgram(lambda a, b: a * b, [w, x], 1,
                                    train=False, recording=recording)
    assert captures == [False] * (2 if recording else 1)
    assert prog.fwd_graph.generators  # replays draw new random numbers


def _mlp_executor():
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
        bn = mx.sym.BatchNorm(fc, fix_gamma=False, name="bn")
        sym = mx.sym.SoftmaxOutput(bn, name="softmax")
    ex = sym.simple_bind(CPU, data=(6, 5), softmax_label=(6,))
    rng = np.random.RandomState(0)
    ex.copy_params_from({"fc_weight": rng.normal(0, 0.5, (4, 5)),
                         "bn_gamma": np.ones(4, np.float32)})
    ex.set_args(data=rng.uniform(-1, 1, (6, 5)).astype(np.float32),
                softmax_label=rng.randint(0, 4, (6,)).astype(np.float32))
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3,
                           rescale_grad=1 / 6)
    return ex, names, opt, mx.optimizer.get_updater(opt)


def _state(ex, updater):
    return ({k: v.asnumpy() for k, v in {**ex.arg_dict,
                                         **ex.aux_dict}.items()},
            {i: s.numpy().copy() for i, s in updater.states.items()})


def test_module_step_captures_with_the_collector_off(captures):
    """The warm-up runs are undone: the stand-in capture then runs the step
    once, with the hyperparameter tensor still zero (a replay writes it
    first), so the weights and momenta stay and the moving stats move
    once, as one training forward moves them."""
    ex, names, opt, updater = _mlp_executor()
    indices = list(range(len(names)))
    updater.ensure_states(indices, [ex.arg_dict[n] for n in names])
    before = _state(ex, updater)
    bound = executor_mod._Bound(ex, updater, indices, names)
    step = executor_mod._FusedStep(ex, opt, names, (0, 1, 1, 1), bound)
    assert step.graph is None  # on the CPU it runs eagerly
    step._capture(bound)
    assert captures == [False] and step.captures == 1
    assert step.graph.generators  # replays draw new random numbers
    once = _mlp_executor()[0]
    once.forward(is_train=True)
    args, states = _state(ex, updater)
    for k, v in args.items():
        want = once.aux_dict[k].asnumpy() if k in ex.aux_dict \
            else before[0][k]
        np.testing.assert_array_equal(v, want, err_msg=k)
    assert not np.array_equal(args["bn_moving_mean"],
                              before[0]["bn_moving_mean"])
    for i, v in states.items():
        np.testing.assert_array_equal(v, before[1][i], err_msg=str(i))


def test_module_step_binds_rebound_arrays_to_the_captured_ones(captures):
    ex, names, opt, updater = _mlp_executor()
    indices = list(range(len(names)))
    updater.ensure_states(indices, [ex.arg_dict[n] for n in names])
    bound = executor_mod._Bound(ex, updater, indices, names)
    step = executor_mod._FusedStep(ex, opt, names, (0, 1, 1, 1), bound)
    step._capture(bound)
    (params, others, auxs), states = step.static
    weight = ex.arg_dict["fc_weight"]
    weight._data = torch.full((4, 5), 2.0)  # a rebind, as `x[:] = v` makes
    updater.set_states(updater.get_states())  # new state tensors
    updater.ensure_states(indices, [ex.arg_dict[n] for n in names])
    bound = executor_mod._Bound(ex, updater, indices, names)
    bound.bind_to(step.static)
    assert weight._data is params[names.index("fc_weight")]
    np.testing.assert_array_equal(weight.asnumpy(), 2.0)
    for i, s in zip(indices, states):
        assert updater.states[i] is s[0]


def test_inference_forward_captures_with_the_collector_off(captures):
    """The inference forward of a ``grad_req="null"`` executor (each
    serving bucket's): captured with the collector held off over the bound
    tensors; an array rebound since the capture is copied into the
    captured tensor and bound to it again before the replay; each call
    returns copies of the static outputs."""
    with mx.name.NameManager():
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                   name="fc")
    ex = fc.simple_bind(CPU, grad_req="null", data=(2, 4))
    ex.copy_params_from({"fc_weight": np.ones((3, 4), np.float32)})
    fwd = executor_mod._Inference(ex)
    assert fwd.graph is None  # on the CPU it runs eagerly
    fwd._capture()
    assert captures == [False] and fwd.captures == 1
    assert fwd.graph.generators
    weight = ex.arg_dict["fc_weight"]
    captured = weight._data
    weight._data = torch.full((3, 4), 2.0)  # a rebind
    ex.arg_dict["data"]._data.copy_(torch.ones(2, 4))
    fwd.outputs = [fwd.run()[0] * 0 + 7]  # what a replay leaves behind
    out = fwd()
    assert weight._data is captured
    np.testing.assert_array_equal(captured.numpy(), 2.0)
    assert out[0] is not fwd.outputs[0]
    np.testing.assert_array_equal(out[0].numpy(), 7.0)


def test_inference_forward_captures_into_the_executor_pool(captures,
                                                           monkeypatch):
    """A Predictor gives all its bucket executors one memory pool
    (``_graph_pool``); the inference capture passes it to the graph."""
    pools = []
    graph = torch.cuda.graph

    def recording(g, pool=None, stream=None, capture_error_mode=None):
        pools.append(pool)
        return graph(g, pool, stream, capture_error_mode)

    monkeypatch.setattr(torch.cuda, "graph", recording)
    with mx.name.NameManager():
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                   name="fc")
    shared = object()
    for rows in (2, 4):
        ex = fc.simple_bind(CPU, grad_req="null", data=(rows, 4))
        ex._graph_pool = shared
        executor_mod._Inference(ex)._capture()
    assert pools == [shared, shared] and captures == [False, False]


def test_capture_stream_waits_back_when_the_block_raises(captures,
                                                         monkeypatch):
    """The current stream waits for the side stream, and the collector is
    back on, even when a warm-up call inside raises."""
    waits = []
    monkeypatch.setattr(_Stream, "wait_stream",
                        lambda self, other: waits.append(other))
    with pytest.raises(RuntimeError, match="warm-up"):
        with compile_cache.capture_stream("cpu"):
            assert not gc.isenabled()
            raise RuntimeError("warm-up")
    assert len(waits) == 2  # the side stream on the current, and back


def test_module_profiles_are_taken_before_the_noise_graphs(monkeypatch):
    """`chip_smoke.module_phase` profiles the full-width Module steps
    before `module_checks` makes and destroys the graphs of its noise
    reading. Profiled after those and after later profiler sessions, the
    fused step's replay segfaulted inside torch.profiler's graph launch,
    where plain replays at the same point ran (ROADMAP C.4,
    `chip_profile_order.py`)."""
    import chip_smoke as cs

    order = []
    monkeypatch.setattr(cs, "module_full_width",
                        lambda torch_, mx_, smi, fused: (
                            {}, "fused" if fused else "eager"))
    monkeypatch.setattr(cs, "profile_step",
                        lambda torch_, step, must_run: order.append(step))
    monkeypatch.setattr(cs, "module_checks",
                        lambda mx_, workdir: order.append("checks") or {})
    _, profiles = cs.module_phase(torch, "card", "unused", profile=True)
    assert order == ["fused", "eager", "checks"]
    assert set(profiles) == {"module_fused", "module_eager"}
