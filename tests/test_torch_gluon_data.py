"""The port's `gluon.data` (`mxnet_tpu_torch/gluon/data/`) held to the JAX
package's on the CPU: samplers under one numpy seed, the dataset
combinators, and `DataLoader` batches, each equal to the JAX package's
exactly (the loader moves values, it computes none). The port's three
worker paths (the loading thread, a thread pool and worker processes) are
held to the JAX package's same-process and thread-pool batches, under each
``last_batch``; an abandoned epoch leaves no worker alive.
"""
import gc
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu_torch.gluon import data as tdata

CPU = mx.cpu()


def arrays(seed=0, n=11):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 3, 4)).astype(np.float32),
            rng.randint(0, 5, n).astype(np.int32))


def as_numpy(batch):
    if isinstance(batch, (list, tuple)):
        return [as_numpy(b) for b in batch]
    return batch.asnumpy()


def epochs(loader, n=2):
    return [[as_numpy(b) for b in loader] for _ in range(n)]


def assert_same(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_samplers_under_a_seed():
    got, want = [], []
    for pkg, out in ((tdata, got), (jdata, want)):
        np.random.seed(5)
        out.append(list(pkg.RandomSampler(10)))
        out.append(list(pkg.SequentialSampler(4)))
        for last in ("keep", "discard", "rollover"):
            bs = pkg.BatchSampler(pkg.SequentialSampler(10), 4, last)
            out.append((list(bs), len(bs), list(bs), len(bs)))
    assert got == want
    with pytest.raises(ValueError, match="last_batch"):
        list(tdata.BatchSampler(tdata.SequentialSampler(3), 2, "pad"))


def test_dataset_combinators():
    x, y = arrays()
    for pkg, ctx in ((tdata, CPU), (jdata, None)):
        ds = pkg.ArrayDataset(x, y)
        yield_ = [
            ds[3],
            len(ds.take(4)), len(ds.take(None)),
            [ds.filter(lambda item: item[1] > 2)[i][1]
             for i in range(len(ds.filter(lambda item: item[1] > 2)))],
            [ds.sample([4, 1, 1])[i][1] for i in range(3)],
            ds.transform(lambda a, b: (a.sum(), b * 2))[5],
            ds.transform(lambda a, b: b + 1, lazy=False)[2],
            ds.transform_first(lambda a: a.shape)[6],
            pkg.SimpleDataset([7, 8, 9]).transform(lambda v: v * 3)[1],
        ]
        if pkg is tdata:
            got = yield_
            nd1 = pkg.ArrayDataset(mx.nd.array(y.astype(np.float32),
                                               ctx=ctx))[2]
        else:
            want = yield_
            jnd1 = pkg.ArrayDataset(jmx.nd.array(y.astype(np.float32)))[2]
    np.testing.assert_array_equal(got[0][0], want[0][0])
    assert got[0][1] == want[0][1]
    assert got[1:5] == want[1:5]
    assert got[5][0] == pytest.approx(want[5][0]) and got[5][1] == want[5][1]
    assert got[6:] == want[6:]
    assert isinstance(nd1, np.floating) and nd1 == jnd1
    with pytest.raises(IndexError):
        tdata.ArrayDataset(x).take(2)[2]


def test_record_file_dataset(tmp_path):
    from mxnet_tpu import recordio as jrec

    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, jrec.pack(jrec.IRHeader(0, float(i), i, 0),
                                 bytes([i]) * (i + 1)))
    w.close()
    got, want = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(got) == len(want) == 5
    assert [got[i] for i in range(5)] == [want[i] for i in range(5)]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_loader_batches_equal_the_jax_package_in_every_worker_mode(
        last_batch):
    x, y = arrays()
    kw = dict(batch_size=4, shuffle=True, last_batch=last_batch)
    np.random.seed(3)
    want = epochs(jdata.DataLoader(jdata.ArrayDataset(x, y), **kw))
    np.random.seed(3)
    want_threads = epochs(jdata.DataLoader(jdata.ArrayDataset(x, y),
                                           num_workers=2, **kw))
    assert_same(want_threads, want)
    ds = tdata.ArrayDataset(x, y)
    for mode in ({}, {"num_workers": 2}, {"num_workers": 2,
                                           "thread_pool": False}):
        np.random.seed(3)
        got = epochs(tdata.DataLoader(ds, **kw, **mode))
        assert_same(got, want)


def test_loader_batchify_sampler_and_nd_items():
    """A custom ``batchify_fn`` and ``batch_sampler`` in worker processes,
    NDArray items stacked, ``pin_memory`` (pinned only with a card):
    every batch a CPU array equal to the JAX package's."""
    x, y = arrays(seed=1, n=9)
    sampler = [[0, 1], [8, 2, 3], [5]]

    def run(pkg, nd, ctx, **kw):
        items = pkg.SimpleDataset([nd.array(x[i], ctx=ctx)
                                   for i in range(9)])
        plain = [as_numpy(b) for b in pkg.DataLoader(
            items, batch_sampler=sampler, **kw)]
        sums = [as_numpy(b) for b in pkg.DataLoader(
            pkg.ArrayDataset(x, y), batch_size=4,
            batchify_fn=lambda d: np.stack([a for a, _ in d]).sum(0))]
        return plain, sums

    want = run(jdata, jmx.nd, None)
    got = run(tdata, mx.nd, CPU, pin_memory=True, num_workers=2)
    assert_same(list(got), list(want))
    batch = next(iter(tdata.DataLoader(tdata.ArrayDataset(x, y),
                                       batch_size=3, pin_memory=True)))
    assert all(b.context == CPU for b in batch)
    procs = next(iter(tdata.DataLoader(tdata.ArrayDataset(x),
                                       batch_size=3, num_workers=2,
                                       thread_pool=False)))
    np.testing.assert_array_equal(procs.asnumpy(), x[:3])
    with pytest.raises(ValueError, match="batch_sampler"):
        tdata.DataLoader(tdata.ArrayDataset(x), batch_size=2,
                         batch_sampler=sampler)


def test_an_abandoned_epoch_leaves_no_worker_alive():
    x, y = arrays(n=40)
    ds = tdata.ArrayDataset(x, y)
    it = iter(tdata.DataLoader(ds, batch_size=2, num_workers=3,
                               thread_pool=False))
    next(it)
    procs = list(it._pool._pool)
    assert len(procs) == 3 and all(p.is_alive() for p in procs)
    del it
    gc.collect()
    assert not any(p.is_alive() for p in procs)
    assert all(p.pid != os.getpid() for p in procs)

    it = iter(tdata.DataLoader(ds, batch_size=2, num_workers=3))
    next(it)
    threads = list(it._pool._threads)
    assert threads
    del it
    gc.collect()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


CLOSE_IN_FLIGHT = '''
import numpy as np
from mxnet_tpu_torch.gluon import data as gdata


class Big(gdata.Dataset):
    def __len__(self):
        return 256

    def __getitem__(self, i):
        return np.full((3, 224, 224), i, np.float32), np.float32(i)


if __name__ == "__main__":
    loader = gdata.DataLoader(Big(), batch_size=32, num_workers=4,
                              thread_pool=False)
    for _ in range(6):
        it = iter(loader)
        next(it)
        it.close()
    del it
    gdata.dataloader.shutdown_worker_processes()
    print("closed")
'''


def test_closing_an_epoch_with_batches_in_flight_returns(tmp_path):
    """An epoch closed while its worker processes send 19 MB batches: a
    worker stopped mid-send left `Pool.terminate` waiting forever on the
    pool's result thread."""
    script = tmp_path / "close_in_flight.py"
    script.write_text(CLOSE_IN_FLIGHT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    done = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=60)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.split() == ["closed"]
