"""The port's roofline observatory (`mxnet_tpu_torch.observatory`) and the
per-entry cost records of its `compile_cache`, held to the JAX package's
(`mxnet_tpu.observatory`, after `tests/python/unittest/test_observatory.py`).

* the roofline math takes the same fixture of flops, bytes and peaks in
  both packages (`test_attribute_compute_bound_fixture`,
  `test_attribute_bandwidth_and_comm_bounds`) and must give the same row;
* a matmul program's counted FLOPs (`FlopCounterMode` in the port, XLA's
  cost analysis in the JAX package) agree;
* the probes run on the device named (``cpu`` here, tiny shapes), persist
  with provenance and re-probe on a mismatch; without a card the default
  raises;
* the three instrumented lanes (the fused step, the Predictor, the
  generation tick) publish their gauges;
* a fresh interpreter with the observatory off pays nothing.

Tolerance: the rows are compared exactly (the same float operations on
the same inputs); the matmul FLOPs exactly (2 n^3 both).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu_torch as pmx
from mxnet_tpu import observatory as jobs
from mxnet_tpu.compile_cache import CompileCache as JCache
from mxnet_tpu_torch import observatory as pobs
from mxnet_tpu_torch import telemetry as ptel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.compile_cache import CompileCache as PCache
from mxnet_tpu_torch.compile_cache import GraphProgram

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DIM, CLASSES = 8, 4
_PK = {"matmul_flops": {"float32": 1e12, "bfloat16": 2e12},
       "hbm_bytes_per_s": 1e11, "collective_bytes_per_s": 1e10}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """The observatory and telemetry on over empty lanes, tiny probes; the
    process state (and any measured peaks) restored after."""
    monkeypatch.setenv("MXNET_OBSERVATORY_PROBE_N", "64")
    monkeypatch.setenv("MXNET_OBSERVATORY_PROBE_MB", "2")
    monkeypatch.delenv("MXNET_OBSERVATORY_DIR", raising=False)
    was = (pobs.enabled(), ptel.enabled())
    saved = dict(pobs._peaks)
    pobs.reset()
    ptel.reset()
    ptel.enable()
    pobs.enable()
    yield
    pobs.reset()
    ptel.reset()
    pobs._peaks.clear()
    pobs._peaks.update(saved)
    pobs.enable(was[0])
    ptel.enable(was[1])


@pytest.mark.parametrize("args,kw", [
    ((2e9, 1e6, 0), {"wall_s": 4e-3, "exec_s": 3e-3}),    # compute-bound
    ((1e6, 1e9, 0), {"wall_s": 2e-2}),                    # bandwidth-bound
    ((1e6, 1e6, 1e9), {"wall_s": 0.2}),                   # comm-bound
    ((2e9, 0, 0), {"dtype": "bfloat16", "wall_s": 1e-3}),  # bf16 peak
    ((0, 0, 0), {}),                                      # nothing counted
])
def test_attribute_fixture_matches(args, kw):
    """The JAX package's fixtures through both `attribute`s: equal rows."""
    assert pobs.attribute(*args, _PK, **kw) == jobs.attribute(*args, _PK,
                                                               **kw)


def test_attribute_compute_bound_fixture():
    row = pobs.attribute(2e9, 1e6, 0, _PK, wall_s=4e-3, exec_s=3e-3)
    assert row["roofline_bound"] == "compute"
    assert row["mfu"] == pytest.approx(0.5)
    assert row["mbu"] == pytest.approx(2.5e-3)
    assert row["host_gap_us"] == pytest.approx(1e3)


def test_attribute_bandwidth_and_comm_bounds():
    row = pobs.attribute(1e6, 1e9, 0, _PK, wall_s=2e-2)
    assert row["roofline_bound"] == "bandwidth" and \
        row["mbu"] == pytest.approx(0.5)
    row = pobs.attribute(1e6, 1e6, 1e9, _PK, wall_s=0.2)
    assert row["roofline_bound"] == "comm" and \
        row["comm_fraction"] == pytest.approx(1.0)


def test_matmul_flops_match_xla_cost_analysis():
    """One 128 x 128 matmul program in each package's cache: the port's
    FlopCounterMode count equals XLA's cost analysis; its bytes follow
    the read-once model (two inputs, one output)."""
    n = 128
    jc = JCache("obs_parity")
    a = jnp.ones((n, n), jnp.float32)
    mm = jc.get_or_build(("mm",), lambda: jax.jit(lambda x, y: x @ y))
    jax.block_until_ready(mm(a, a))
    jflops = jc.entry_cost(("mm",))["flops"]
    pc = PCache("obs_parity")
    w = torch.ones(n, n)
    prog = pc.get_or_build(("mm",), lambda: GraphProgram(
        lambda i: ((w[i.clamp(0, n - 1)] @ w),), [(n,)], "cpu",
        reads=lambda: [w]))
    prog(np.arange(n))
    cost = pc.entry_cost(("mm",))
    assert cost["flops"] == jflops == 2 * n ** 3
    assert cost["bytes_accessed"] == 2 * n * n * 4 + n * 8
    assert pc.entry_dtype(("mm",)) == "float32"


def test_probes_persist_with_provenance(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_OBSERVATORY_DIR", str(tmp_path))
    pk = pobs.peaks(refresh=True, device="cpu")
    runs = pobs._probe_runs
    assert pk["source"] == "measured"
    assert set(pk["matmul_flops"]) == {"float32", "bfloat16"}
    assert pk["hbm_bytes_per_s"] > 0 and pk["collective_bytes_per_s"] is None
    (path,) = list(tmp_path.glob("peaks_cpu_*.json"))
    pobs._peaks.clear()
    assert pobs.peaks(device="cpu")["source"] == "disk"
    assert pobs._probe_runs == runs
    doc = json.loads(path.read_text())
    doc["provenance"]["probe_n"] = 9999
    path.write_text(json.dumps(doc))
    pobs._peaks.clear()
    assert pobs.peaks(device="cpu")["source"] == "measured"
    assert pobs._probe_runs == runs + 1
    assert pobs.probe_verdict().startswith("measured:cpu/")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            pobs.peaks()


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=CLASSES, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def test_three_lanes_publish_their_gauges():
    """fit's fused step, a Predictor and a generation engine on the CPU:
    each lane names a counted program, and `summary` publishes
    ``step.mfu`` / ``step.mbu``, ``serving.mfu`` and
    ``serving.generation.tick_mbu``."""
    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (32, DIM)).astype(np.float32)
    Y = rng.randint(0, CLASSES, 32).astype(np.float32)
    with pmx.cpu():
        m = pmx.mod.Module(_mlp(pmx), context=pmx.cpu())
        m.fit(pmx.io.NDArrayIter(X, Y, batch_size=8), num_epoch=1,
              optimizer_params=(("learning_rate", 0.1),),
              initializer=pmx.init.Xavier())
        pred = m.as_predictor(buckets=(4,))
        for _ in range(3):
            pred.predict(X[:4])
    cfg = TransformerLMConfig(vocab_size=32, d_model=16, n_heads=2, d_ff=32,
                              n_layers=1, max_len=32, dtype="float32")
    eng = GenerationEngine(TransformerLM(cfg, device="cpu"), max_slots=2,
                           max_len=32, buckets=(8,), start=False)
    eng.generate([1, 2, 3], max_new_tokens=4)
    eng.close()
    summary = pobs.summary(device="cpu")
    assert set(summary["lanes"]) == {"step", "serving", "generation.tick"}
    step = summary["lanes"]["step"]
    # forward + backward of fc1 and fc2 at batch 8: 3 x 2 x 8 x (8x16 + 16x4)
    assert step["flops"] == 3 * 2 * 8 * (DIM * 16 + 16 * CLASSES) - \
        2 * 8 * DIM * 16
    assert step["mfu"] > 0 and step["mbu"] > 0
    assert summary["lanes"]["serving"]["flops"] == \
        2 * 4 * (DIM * 16 + 16 * CLASSES)
    tick = summary["lanes"]["generation.tick"]
    # which roof binds on the CPU depends on the tiny probes' peaks
    assert tick["mbu"] > 0 and tick["bytes_accessed"] > 0
    for g in ("step.mfu", "step.mbu", "serving.mfu",
              "serving.generation.tick_mbu"):
        assert ptel.get(g) is not None, g
    assert pobs.cached_summary() is summary
    assert ptel.snapshot()["observatory"] is summary


def test_disabled_zero_overhead_subprocess(tmp_path):
    """A fresh interpreter with ``MXNET_OBSERVATORY`` unset: fit, serving
    and generation traffic run no probe, keep no lane state, count no
    program, write no file and publish no roofline gauge."""
    code = r"""
import os, threading
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compile_cache, observatory, telemetry
from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
from mxnet_tpu_torch.serving.generation import GenerationEngine
assert not observatory.enabled()
with mx.cpu():
    x = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(x, num_hidden=2,
                                                     name="fc"), name="softmax")
    m = mx.mod.Module(net, context=mx.cpu())
    X = np.ones((8, 3), np.float32); Y = np.zeros(8, np.float32)
    m.fit(mx.io.NDArrayIter(X, Y, batch_size=4), num_epoch=1)
    m.as_predictor(buckets=(4,)).predict(X[:3])
cfg = TransformerLMConfig(vocab_size=16, d_model=16, n_heads=2, d_ff=32,
                          n_layers=1, max_len=16, dtype="float32")
eng = GenerationEngine(TransformerLM(cfg, device="cpu"), max_slots=2,
                       max_len=16, buckets=(8,))
assert len(eng.generate([1, 2, 3], max_new_tokens=3)) == 3
eng.close()
assert observatory._probe_runs == 0 and observatory._lanes == {}
assert observatory._peaks == {} and observatory.cached_summary() is None
assert observatory.summary() == {"enabled": False}
assert all(getattr(p, "cost", None) is None
           for c in compile_cache.all_caches() for p in c.values())
for g in ("step.mfu", "step.mbu", "serving.mfu",
          "serving.generation.tick_mbu"):
    assert telemetry.get(g) is None, g
assert os.listdir(os.environ["MXNET_OBSERVATORY_DIR"]) == []
assert not any("observ" in t.name for t in threading.enumerate())
print("OBSERVATORY_OFF_OK")
"""
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    env = dict(os.environ, MXNET_OBSERVATORY_DIR=str(obs_dir))
    for k in ("MXNET_OBSERVATORY", "MXNET_TELEMETRY", "MXNET_HEALTH"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OBSERVATORY_OFF_OK" in r.stdout


def test_matmul_out_dtype_overloads_are_counted():
    """``bmm`` / ``mm`` with ``out_dtype`` (the transformer's bf16 scores
    into fp32): torch's own FLOP formula takes the extra argument for its
    ``out_shape`` and raises; the port's counts 2 m n k a batch."""
    from mxnet_tpu_torch.compile_cache import measure_cost

    a = torch.empty(2, 3, 4, dtype=torch.bfloat16, device="meta")
    b = torch.empty(2, 4, 5, dtype=torch.bfloat16, device="meta")
    _, cost = measure_cost(lambda: (torch.bmm(a, b, out_dtype=torch.float32),
                                    torch.mm(a[0], b[0],
                                             out_dtype=torch.float32)))
    assert cost["flops"] == 2 * 2 * 3 * 4 * 5 + 2 * 3 * 4 * 5


@pytest.mark.parametrize("groups", [1, 8], ids=["dense", "depthwise"])
def test_convolution_backward_counts_one_forward_a_gradient(groups):
    """A convolution's backward counts one forward's FLOPs for each
    gradient: torch's own formula takes a grouped convolution's weight
    gradient as ungrouped, and counted mobilenet's depthwise layers many
    times over."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.compile_cache import measure_cost

    x = torch.randn(2, 8, 9, 9, requires_grad=True)
    w = torch.randn(16, 8 // groups, 3, 3, requires_grad=True)
    forward = 2 * 2 * 16 * 7 * 7 * (8 // groups) * 9
    _, cost = measure_cost(lambda: F.conv2d(x, w, groups=groups).sum()
                           .backward())
    assert cost["flops"] == 3 * forward
    _, cost = measure_cost(lambda: F.conv2d(x.detach(), w, groups=groups)
                           .sum().backward())
    assert cost["flops"] == 2 * forward
