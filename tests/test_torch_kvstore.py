"""The port's kvstores (`mxnet_tpu_torch.kvstore`, `.parallel.dist`) held to
the JAX package's on the CPU, with 2-bit gradient compression.

- The local store's compression ladder with the ``test`` optimizer (the port
  of `test_local_kvstore_compression`).
- Error feedback: the local store and the one-worker ``dist_sync`` store
  pull the same values for the same pushes, and those equal the JAX stores'
  (the port of `test_compression_error_feedback_parity_local_vs_dist`).
- Two worker processes over gloo: each pushes its own gradients, and every
  worker pulls the sum over workers of the reference's expected-value
  simulation (`expected_2bit`, as in `test_gradient_compression.py`).
- Two `gluon.Trainer` workers over gloo where one worker's backward leaves a
  parameter without a gradient: it still pushes (zeros), so both workers
  issue the same all-reduces in the same order and pull the same sums.
- Two gloo workers pushing row-sparse gradients of different row counts:
  the padded all-gather, the merged sum applied by the store's SGD or
  handed back sparse, and a Trainer over a SparseEmbedding.

Pulled values are compared exactly: every step of the path is exact fp32
(codes times the threshold, summed over at most two workers).
"""
import os
import queue
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from mxnet_tpu_torch import kvstore as kvs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import KVStoreDistTPUSync

WORKERS = 2
DIST_SHAPES = {"a": (2, 3), "b": (33, 65)}
DIST_STEPS = 3
DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _one_process(monkeypatch):
    """No coordinator in this process: dist stores are single-process."""
    for name in ("MXNET_COORDINATOR", "DMLC_PS_ROOT_URI"):
        monkeypatch.delenv(name, raising=False)


def expected_2bit(arr, curr_residual, threshold):
    """The reference's simulation: the residual folds in; {-t, 0, +t} out."""
    r = np.asarray(arr, np.float32) + curr_residual
    decompr = np.zeros_like(r)
    new_residual = r.copy()
    pos = r >= threshold
    neg = r <= -threshold
    decompr[pos] = threshold
    decompr[neg] = -threshold
    new_residual[pos] -= threshold
    new_residual[neg] += threshold
    return new_residual, decompr


def test_local_kvstore_compression_ladder():
    """One worker, compression and the ``test`` optimizer at rate 2: a push
    below the threshold leaves the value, the next one fires."""
    rate, t, shape = 2, 0.5, (2, 3)
    kv = kvs.create("device")
    kv.set_optimizer(topt.create("test", rescale_grad=rate))
    kv.set_gradient_compression({"type": "2bit", "threshold": t})
    kv.init("a", torch.zeros(shape))
    val = torch.zeros(shape)
    for push, want in [(0.4, 0.0), (t - 0.4, t * rate), (0.0, t * rate)]:
        kv.push("a", torch.full(shape, push))
        kv.pull("a", out=val)
        np.testing.assert_allclose(val.numpy(), want)
    with pytest.raises(MXNetError):
        kv.init("a", torch.zeros(shape))
    with pytest.raises(MXNetError):
        kv.push("never_inited", torch.zeros(shape))
    with pytest.raises(MXNetError):
        kvs.create("dist_async")


def _pulled_after_each_push(kv, seq, zeros, tensor):
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("w", zeros())
    outs = []
    for g in seq:
        kv.push("w", tensor(g))
        out = zeros()
        kv.pull("w", out=out)
        outs.append(np.asarray(out.numpy() if isinstance(out, torch.Tensor)
                               else out.asnumpy()).copy())
    return outs


def test_error_feedback_parity_local_vs_dist_and_jax():
    """Both stores keep the residual per key: with one worker the dist
    store's per-worker residual and the local store's are the same state, so
    the same pushes pull the same values, and the JAX stores' values."""
    # imported here, not at the top: the gloo test's worker processes
    # import this module, and need neither JAX nor the JAX package
    import mxnet_tpu as mx
    from mxnet_tpu import kvstore as jkvs

    rng = np.random.RandomState(5)
    seq = [rng.uniform(-1, 1, (64,)).astype(np.float32) for _ in range(4)]
    port = {name: _pulled_after_each_push(
        kvs.create(name, device="cpu"), seq, lambda: torch.zeros(64),
        torch.from_numpy) for name in ("local", "dist_sync")}
    ref = {name: _pulled_after_each_push(
        jkvs.create(name), seq, lambda: mx.nd.zeros((64,)), mx.nd.array)
        for name in ("local", "dist_tpu_sync")}
    for step in range(len(seq)):
        want = ref["local"][step]
        for got in (port["local"], port["dist_sync"], ref["dist_tpu_sync"]):
            np.testing.assert_array_equal(got[step], want,
                                          err_msg=f"step {step}")
    # the residual carries: sub-threshold values come out at a later push
    assert any(np.abs(x).max() > 0 for x in port["local"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_worker(rank, port, results):
    """One worker of the two-process test: a compressed store fed this
    rank's gradients through grouped pushes, and a dense store."""
    os.environ.update(MXNET_COORDINATOR=f"127.0.0.1:{port}",
                      MXNET_NUM_PROCESSES=str(WORKERS),
                      MXNET_PROCESS_ID=str(rank), MXNET_INIT_TIMEOUT_S="30")
    try:
        kv = kvs.create("dist_sync", device="cpu")
        assert isinstance(kv, KVStoreDistTPUSync)
        assert (kv.rank, kv.num_workers) == (rank, WORKERS)
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        keys = sorted(DIST_SHAPES)
        for k in keys:
            kv.init(k, torch.zeros(DIST_SHAPES[k]))
        rng = np.random.RandomState(100 + rank)
        pulled = []
        for _ in range(DIST_STEPS):
            grads = [torch.from_numpy(rng.uniform(
                -1, 1, DIST_SHAPES[k]).astype(np.float32)) for k in keys]
            kv.push(keys, grads)
            outs = [torch.zeros(DIST_SHAPES[k]) for k in keys]
            kv.pull(keys, out=outs)
            pulled.append([o.numpy() for o in outs])
        dense = kvs.create("dist_sync", device="cpu")
        dense.init("d", torch.zeros(4))
        dense.push("d", torch.arange(4.0) * (rank + 1))
        out = torch.zeros(4)
        dense.pull("d", out=out)
        kv.barrier()
        results.put((rank, pulled, out.numpy()))
    except BaseException as e:  # report to the parent, which fails the test
        results.put((rank, repr(e), None))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run_workers(target):
    """Start WORKERS spawned processes of target(rank, port, results) and
    collect each one's (rank, result, extra) within DEADLINE_S; a worker
    that failed sends its error as the result, a string."""
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, port, results))
             for r in range(WORKERS)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + DEADLINE_S  # a hang fails, within 60 s
    try:
        for _ in range(WORKERS):
            rank, result, extra = results.get(
                timeout=max(0.0, deadline - time.monotonic()))
            got[rank] = (result, extra)
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    assert sorted(got) == list(range(WORKERS)), f"workers answered: {got}"
    for rank, (result, _) in got.items():
        assert not isinstance(result, str), f"worker {rank}: {result}"
    assert all(p.exitcode == 0 for p in procs)
    return got


def test_two_workers_gloo_compressed_sum():
    got = _run_workers(_dist_worker)
    for rank, (pulled, dense) in got.items():
        np.testing.assert_array_equal(dense, np.arange(4.0) * 3)
    # every worker's residuals, simulated; the pull is the sum over workers
    keys = sorted(DIST_SHAPES)
    rngs = [np.random.RandomState(100 + r) for r in range(WORKERS)]
    residual = [[np.zeros(DIST_SHAPES[k], np.float32) for k in keys]
                for _ in range(WORKERS)]
    for step in range(DIST_STEPS):
        want = [np.zeros(DIST_SHAPES[k], np.float32) for k in keys]
        for r in range(WORKERS):
            for i, k in enumerate(keys):
                g = rngs[r].uniform(-1, 1, DIST_SHAPES[k]).astype(np.float32)
                residual[r][i], decompr = expected_2bit(g, residual[r][i],
                                                        0.5)
                want[i] += decompr
        for rank in range(WORKERS):
            for i, k in enumerate(keys):
                np.testing.assert_array_equal(
                    got[rank][0][step][i], want[i],
                    err_msg=f"rank {rank} step {step} key {k}")


def _trainer_worker(rank, port, results):
    """One worker of the unused-parameter test: SGD at lr 0.1 over `a` and
    `b` (3 x 4, ones) through a dense ``dist_sync`` store. Worker 0's loss
    is a.sum() + 10 b.sum() in both steps; worker 1's is 2 a.sum() in step
    0, so its backward gives `b` no gradient, and adds 10 b.sum() in step
    1."""
    from mxnet_tpu_torch.gluon import Trainer

    os.environ.update(MXNET_COORDINATOR=f"127.0.0.1:{port}",
                      MXNET_NUM_PROCESSES=str(WORKERS),
                      MXNET_PROCESS_ID=str(rank), MXNET_INIT_TIMEOUT_S="30")
    try:
        a = torch.nn.Parameter(torch.ones(3, 4))
        b = torch.nn.Parameter(torch.ones(3, 4))
        trainer = Trainer({"a": a, "b": b}, "sgd", {"learning_rate": 0.1},
                          kvstore="dist_sync")
        seen = []
        for step in range(2):
            loss = (1 + rank) * a.sum()
            if rank == 0 or step == 1:
                loss = loss + 10 * b.sum()
            loss.backward()
            trainer.step(1, ignore_stale_grad=True)
            seen.append((a.detach().numpy().copy(),
                         b.detach().numpy().copy()))
        trainer._kvstore.barrier()
        results.put((rank, seen, None))
    except BaseException as e:  # report to the parent, which fails the test
        results.put((rank, repr(e), None))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_two_workers_gloo_trainer_pushes_unused_parameters():
    """Every worker pushes every parameter that requires grad: the sums are
    a = 1 - 0.1 * (1 + 2) = 0.7, then 0.4, on both workers. `b` moves on
    worker 0 alone in step 0, where worker 1's is stale: 1 - 0.1 * 10."""
    got = _run_workers(_trainer_worker)
    for rank, (seen, _) in got.items():
        (a0, b0), (a1, b1) = seen
        np.testing.assert_allclose(a0, 0.7, rtol=1e-6, err_msg=str(rank))
        np.testing.assert_allclose(a1, 0.4, rtol=1e-6, err_msg=str(rank))
        np.testing.assert_allclose(b0, 0.0 if rank == 0 else 1.0, atol=1e-6)
        np.testing.assert_allclose(b1, b0 - 0.1 * 20, atol=1e-6)


def _dist_sparse_worker(rank, port, results):
    """One worker of the padded row-sparse push: worker 0 pushes rows
    [1, 4], worker 1 rows [4, 6, 8] (three rows: the padding) of a 10 x 3
    key, then a pull applies SGD on the store; a second key is pulled
    sparse through `pull_sparse_grad`; and a Trainer over a
    SparseEmbedding steps on the summed gradient of both workers."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd, telemetry
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

    os.environ.update(MXNET_COORDINATOR=f"127.0.0.1:{port}",
                      MXNET_NUM_PROCESSES=str(WORKERS),
                      MXNET_PROCESS_ID=str(rank), MXNET_INIT_TIMEOUT_S="30")
    try:
        with mx.cpu():
            kv = kvs.create("dist_sync", device="cpu")
            rows = [[1, 4], [4, 6, 8]][rank]
            vals = torch.full((len(rows), 3), float(rank + 1))
            kv.init("w", torch.ones(10, 3))
            kv.init("g", torch.zeros(10, 3))
            kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
            telemetry.reset()
            telemetry.enable()
            kv.push("w", RowSparseNDArray(vals, rows, (10, 3)))
            pushed = telemetry.get("kvstore.push_bytes").value
            telemetry.enable(False)
            out = torch.zeros(10, 3)
            kv.pull("w", out=out)
            kv.push("g", RowSparseNDArray(vals, rows, (10, 3)))
            uniq, summed = kv.pull_sparse_grad("g")
            net = gluon.contrib.nn.SparseEmbedding(10, 2)
            net.initialize(mx.init.One(), ctx=mx.cpu())
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1},
                                    kvstore="dist_sync")
            with autograd.record():
                loss = net(nd.array(rows, dtype="int32")).sum()
            loss.backward()
            trainer.step(1)
            g = net.weight.grad()
            kv.barrier()
            results.put((rank, (out.numpy(), uniq.numpy(), summed.numpy(),
                                pushed, net.weight.data().asnumpy(),
                                g.indices.asnumpy(), g.densified()), None))
    except BaseException as e:  # report to the parent, which fails the test
        results.put((rank, repr(e), None))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_two_workers_gloo_row_sparse_push():
    got = _run_workers(_dist_sparse_worker)
    # the summed gradient: row 1 gets 1, row 4 gets 1 + 2, rows 6 and 8 get 2
    grad = np.zeros((10, 3), np.float32)
    grad[1], grad[4], grad[6], grad[8] = 1, 3, 2, 2
    weight = np.ones((10, 2), np.float32)
    weight[[1, 4, 6, 8]] -= 0.1
    weight[4] -= 0.1  # both workers looked row 4 up
    for rank, (res, _) in got.items():
        out, uniq, summed, pushed, w, idx, densified = res
        np.testing.assert_allclose(out, 1 - 0.5 * grad, err_msg=str(rank))
        np.testing.assert_array_equal(uniq, [1, 4, 6, 8])
        np.testing.assert_allclose(summed, grad[[1, 4, 6, 8]])
        # this worker's stored rows and indices, not the dense 10 x 3
        n_rows = 2 if rank == 0 else 3
        assert pushed == n_rows * (3 * 4 + 4), (rank, pushed)
        np.testing.assert_allclose(w, weight, rtol=1e-6, err_msg=str(rank))
        np.testing.assert_array_equal(idx, [1, 4, 6, 8])
        assert not densified
