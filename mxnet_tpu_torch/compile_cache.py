"""Named caches of built programs, and the CUDA-graph program they hold.

The counterpart of the part of `mxnet_tpu/compile_cache.py` that the
generation engine uses. There a miss builds a `jax.jit` executable, which
runs every later call from its compiled form. Here a miss builds a
`GraphProgram`: on the card its first call captures the function once as a
`torch.cuda.CUDAGraph` over static input and output buffers, and every
later call refills the inputs and replays the graph; on the CPU it calls
the eager function. Either way `misses` counts builds exactly, and a
steady state that builds nothing shows as a zero miss delta in
`named_stats`.

Every CUDA graph of the port is captured through `capture` (or, for two
graphs of one function, `capture_stream` and `capture_on`): on a side
stream, under `collector_held`, after `WARMUP_CALLS` eager calls.
`GraphProgram` here, `CachedOp` (`_cached_op.py`), and the Module's
training step and the inference forward (`symbol/executor.py`) use it.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import numpy as np
import torch

__all__ = ["CompileCache", "GraphProgram", "named_stats", "collector_held",
           "capture", "capture_stream", "capture_on", "WARMUP_CALLS"]

# eager calls on a side stream before a capture: the lazy set-up (cuDNN's
# algorithm choice, workspaces, autograd's stream state) that a capture
# must not see
WARMUP_CALLS = 2


@contextlib.contextmanager
def collector_held():
    """Python's cyclic garbage collector run now and held off until the
    block ends; every capture runs inside one. A dead block's or module's
    programs die in reference cycles, and destroying their graphs during a
    capture makes CUDA calls that a capture forbids, which invalidates it
    (seen as cuDNN's CUDNN_STATUS_INTERNAL_ERROR)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@contextlib.contextmanager
def capture_stream(device):
    """The side stream a capture runs on, current inside the block: it
    waits for the current stream first, Python's collector is held
    (`collector_held`) inside, and the current stream waits for it at the
    end, even when the block raises. Eager warm-up calls run inside, before
    `capture_on`."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    try:
        with collector_held(), torch.cuda.stream(stream):
            yield stream
    finally:
        torch.cuda.current_stream(device).wait_stream(stream)


def capture_on(stream, fn, pool=None, generator=None):
    """``fn()`` captured on ``stream`` (from `capture_stream`) as one CUDA
    graph in the memory pool ``pool`` (None: a private one), with
    ``generator``'s state registered when given. Returns ``(graph, what
    fn returned)``. A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def capture(fn, device, pool=None, generator=None, warm_up=None):
    """``fn()`` captured as one CUDA graph on ``device``: `WARMUP_CALLS`
    eager calls of ``fn`` (or one call of ``warm_up`` in their place) and
    the capture, all on a side stream (`capture_stream`). Returns
    ``(graph, what fn returned)``, as `capture_on`."""
    with capture_stream(device) as stream:
        if warm_up is None:
            for _ in range(WARMUP_CALLS):
                fn()
        else:
            warm_up()
        return capture_on(stream, fn, pool, generator)


# `named_stats(name)` must answer "did steady state build anything?" with
# counts that only grow, whatever caches of that name were collected since
_totals_lock = threading.Lock()
_name_totals = {}


def _totals(name):
    with _totals_lock:
        return _name_totals.setdefault(name, {"hits": 0, "misses": 0})


class CompileCache:
    """A named map ``key -> built program`` that counts hits and misses."""

    def __init__(self, name):
        self.name = name
        self.hits = 0
        self.misses = 0
        self._name_totals = _totals(name)
        self._entries = {}
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def values(self):
        return list(self._entries.values())

    def get_or_build(self, key, build):
        """The program cached under `key`; on a miss, ``build()`` makes it."""
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self.hits += 1
                self._name_totals["hits"] += 1
                return fn
            self.misses += 1
            self._name_totals["misses"] += 1
            fn = self._entries[key] = build()
            return fn

    def snapshot(self):
        return {"name": self.name, "entries": len(self._entries),
                "hits": self.hits, "misses": self.misses}


def named_stats(name):
    """``{"hits", "misses"}`` summed over every cache ever named `name`,
    monotonic over the process's life, so deltas are safe to assert on."""
    with _totals_lock:
        return dict(_name_totals.get(name, {"hits": 0, "misses": 0}))


class GraphProgram:
    """`fn` over fixed-shape int64 inputs, called with host values.

    ``fn(*inputs)`` takes device tensors of `shapes` and returns a tuple of
    tensors. A call ``program(*values)`` takes one host array (or int) per
    input and returns the first output as a numpy array: the one copy from
    the device a call makes. The last call's outputs stay in ``outputs``.

    On a CUDA `device` the first call writes its values into static input
    buffers, runs `fn` twice on a side stream (the lazy set-up a capture
    must not see) and captures it once as a CUDA graph in the memory pool
    `pool`; later calls copy their values from pinned host buffers into the
    same inputs and replay the graph. Those first runs repeat what the
    replay computes, so `fn` must be idempotent in its inputs, as a slab
    write of the same rows is. A capture that fails raises; nothing falls
    back to eager calls. On the CPU a call runs `fn` eagerly.

    Calls must not overlap: the engine makes them under its tick lock."""

    def __init__(self, fn, shapes, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs = None
        self.captures = 0
        self._pool = pool
        self._inputs = [torch.zeros(s, dtype=torch.int64, device=self.device)
                        for s in shapes]
        self._pinned = None
        if self.device.type == "cuda":
            self._pinned = [torch.zeros(s, dtype=torch.int64).pin_memory()
                            for s in shapes]

    def __call__(self, *values):
        if self._pinned is None:
            for buf, val in zip(self._inputs, values):
                buf.copy_(torch.as_tensor(np.asarray(val), dtype=torch.int64))
            with torch.inference_mode():
                self.outputs = self.fn(*self._inputs)
            return self.outputs[0].numpy()
        # the pinned buffers are free: every call ends in a copy to the
        # host, which waits for the copies out of them
        for pin, buf, val in zip(self._pinned, self._inputs, values):
            pin.numpy()[...] = val
            buf.copy_(pin, non_blocking=True)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.outputs[0].cpu().numpy()

    def _capture(self):
        with torch.inference_mode():
            self.graph, self.outputs = capture(
                lambda: self.fn(*self._inputs), self.device, self._pool)
        self.captures += 1
