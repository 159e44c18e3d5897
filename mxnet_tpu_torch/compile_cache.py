"""Named caches of built programs, the CUDA-graph program they hold, and
their accounting.

The counterpart of `mxnet_tpu/compile_cache.py`. There a miss builds a
`jax.jit` executable, which runs every later call from its compiled form.
Here a miss builds a program object: `GraphProgram` for the generation
engine, `CachedOp`'s, the Module's fused training step and the inference
forward (`symbol/executor.py`). On the card its first call captures the
function once as a `torch.cuda.CUDAGraph` over static buffers, and every
later call refills the inputs and replays the graph; on the CPU it calls
the eager function. Either way `misses` counts builds exactly, and a
steady state that builds nothing shows as a zero miss delta in
`named_stats`.

Every CUDA graph of the port is captured through `capture` (or, for two
graphs of one function, `capture_stream` and `capture_on`): on a side
stream, under `collector_held`, after `WARMUP_CALLS` eager calls.

Accounting, as in the JAX package: every live cache is in `all_caches`;
`stats`, `name_totals` and `named_stats` sum them, the per-name totals
monotonic over the process's life. The ``compile.*`` series are recorded
even when telemetry is off: ``compile.cache_hits`` /
``compile.cache_misses``, the ``compile.cache_entries`` gauge,
``compile.seconds`` (build time plus the warm-up calls and capture of a
graph, which is where the port pays what XLA's compile cost the JAX
package) and the ``compile.first_call_us`` histogram. A miss after a cache
served hits is a steady-state rebuild, journaled as ``compile_blame`` with
the key's axis that changed (shape, dtype, attribute).

Cost per entry, for the roofline observatory: where the JAX package read
XLA's cost analysis of the compiled program, the port counts while the
observatory is on (``observatory._enabled`` when the entry is built): its
FLOPs by `torch.utils.flop_counter.FlopCounterMode` over the first eager
call (a warm-up call before the capture on the card); its bytes accessed
under a stated model, every tensor the program reads (its inputs, the
parameters and state it closes over) and every output read or written
once, each storage counted once; and its dominant dtype, the type of the
largest of those. FlopCounterMode sees aten's matmuls, convolutions and
attention; it does not see the port's own C++ ops (the K1-K3 kernels)
unless each registers a FLOP formula, so a program that launches one
undercounts. ``entry_cost`` / ``entry_dtype`` read the record.

The JAX package's ``MXNET_COMPILE_CACHE_DIR`` has no counterpart, since
nothing here could persist through it: a CUDA graph lives in its process
and cannot be written out, and the kernels' builds already persist under
``build/`` (`ops/_build.py`). Its on-disk XLA cache and the pause around
donated programs go with it.
`audit_ledger` / `dump_audit` keep the JAX package's audit interface over
what the port records per entry (its key, cost and captures) instead of
HLO program summaries.
"""
from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import threading
import time
import weakref

import numpy as np
import torch

from . import observatory, telemetry

__all__ = ["CompileCache", "GraphProgram", "stats", "named_stats",
           "name_totals", "all_caches", "audit_ledger", "dump_audit",
           "measure_cost", "collector_held", "capture", "capture_stream",
           "capture_on", "WARMUP_CALLS"]

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
def capture_stream(device, owner=None):
    """The side stream a capture runs on, current inside the block: it
    waits for the current stream first, Python's collector is held
    (`collector_held`) inside, and the current stream waits for it at the
    end, even when the block raises. Eager warm-up calls run inside, before
    `capture_on`. When ``owner`` is a program a cache built before (one
    that captures at its first call), the block's host seconds go into
    ``compile.seconds`` and that cache; a capture inside ``build()`` is
    counted by `get_or_build` itself."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    t0 = time.perf_counter()
    try:
        with collector_held(), torch.cuda.stream(stream):
            yield stream
    finally:
        torch.cuda.current_stream(device).wait_stream(stream)
        if getattr(owner, "compile_cache", None) is not None:
            _note_seconds(owner, time.perf_counter() - t0)


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


def capture(fn, device, pool=None, generator=None, warm_up=None,
            owner=None):
    """``fn()`` captured as one CUDA graph on ``device``: `WARMUP_CALLS`
    eager calls of ``fn`` (or one call of ``warm_up`` in their place) and
    the capture, all on a side stream (`capture_stream`, which ``owner``
    is passed to). Returns ``(graph, what fn returned)``, as
    `capture_on`."""
    with capture_stream(device, owner) as stream:
        if warm_up is None:
            for _ in range(WARMUP_CALLS):
                fn()
        else:
            warm_up()
        return capture_on(stream, fn, pool, generator)


def _storages(tensors):
    """{storage key: bytes} of every tensor in ``tensors`` (nested lists and
    tuples walked), each storage once."""
    out = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[(str(x.device), st.data_ptr())] = (st.nbytes(), x.dtype)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)

    walk(tensors)
    return out


def _matmul_flop(a_shape, b_shape, *rest, out_shape=None, **kwargs):
    """2 m n k (times the batch) for ``mm`` / ``bmm``, with or without the
    ``out_dtype`` overload, whose extra argument torch's own formula takes
    for ``out_shape`` (a TypeError)."""
    batch = a_shape[0] if len(a_shape) == 3 else 1
    return 2 * batch * a_shape[-2] * a_shape[-1] * b_shape[-1]


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, *rest,
                        out_shape=None, **kwargs):
    """A convolution's backward: one forward's FLOPs for each gradient it
    computes (``output_mask``). Torch's own formula takes the weight
    gradient of a grouped convolution as ungrouped, so it counted a
    depthwise layer's backward many times over (mobilenet1.0 at 224²: 11.9
    GFLOP against a 1.14 GFLOP forward)."""
    from torch.utils.flop_counter import conv_flop_count

    transposed, output_mask = rest[4], rest[7]
    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * sum(bool(m) for m in output_mask[:2])


def measure_cost(fn, reads=()):
    """``fn()`` under `FlopCounterMode`, and the cost record of the program
    it is: ``(what fn returned, {"flops", "bytes_accessed", "dtype"})``.
    ``reads`` holds the tensors the program reads besides its outputs (its
    inputs, parameters and state). Bytes: each storage of ``reads`` and of
    the outputs once (a read or a write each); dtype: the type of the
    largest such storage. Counting never breaks the program: where the
    counter fails, ``fn()`` runs again without it (the programs counted
    are idempotent in their inputs) and the record is False, a failure
    remembered."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    try:
        with FlopCounterMode(display=False, custom_mapping={
                aten.mm: _matmul_flop, aten.bmm: _matmul_flop,
                aten.convolution_backward: _conv_backward_flop}) as counter:
            out = fn()
    except Exception as e:  # noqa: BLE001 - a formula the counter lacks
        logging.getLogger(__name__).warning(
            "cost count failed (%r); the entry has no cost record", e)
        return fn(), False
    stores = _storages([list(reads), out])
    nbytes = sum(nb for nb, _ in stores.values())
    by_type = {}
    for nb, dt in stores.values():
        name = str(dt).replace("torch.", "")
        by_type[name] = by_type.get(name, 0) + nb
    dtype = max(by_type, key=by_type.get) if by_type else "float32"
    return out, {"flops": float(counter.get_total_flops()),
                 "bytes_accessed": float(nbytes), "dtype": dtype}


def _note_seconds(owner, dt):
    """One build's or capture's host seconds into ``compile.seconds``
    (recorded with telemetry off, as every ``compile.*`` series) and into
    the cache that built ``owner``."""
    telemetry.counter("compile.seconds").inc(dt)
    telemetry.histogram("compile.first_call_us").record(dt * 1e6)
    cache = getattr(owner, "compile_cache", None)
    if cache is not None:
        cache.compile_seconds += dt
        cache._name_totals["compile_seconds"] += dt


_caches = weakref.WeakSet()
_caches_lock = threading.Lock()

# per-NAME hit / miss / seconds totals, monotonic over the process's life:
# `named_stats(name)` must answer "did steady state build anything?" with
# counts that only grow, whatever caches of that name were collected since
_name_totals = {}

# audit ledger: (name, repr(key)) -> the entry's record at its first build
_audit_lock = threading.Lock()
_audit_ledger = {}
_AUDIT_MAX = 256


def _totals(name):
    with _caches_lock:
        t = _name_totals.get(name)
        if t is None:
            t = _name_totals[name] = {"hits": 0, "misses": 0,
                                      "compile_seconds": 0.0}
        return t


def _entries_gauge():
    """Recompute the live-entry gauge over every live cache."""
    with _caches_lock:
        total = sum(len(c) for c in _caches)
    telemetry.gauge("compile.cache_entries").set(total)


class CompileCache:
    """A named map ``key -> built program`` that counts hits, misses and
    build seconds (the ``compile.*`` series), and keeps each program's
    cost record (``entry_cost``) for the observatory."""

    def __init__(self, name):
        self.name = name
        self.hits = 0
        self.misses = 0
        self.compile_seconds = 0.0
        self._name_totals = _totals(name)
        self._entries = {}
        self._lock = threading.Lock()
        with _caches_lock:
            _caches.add(self)

    def __len__(self):
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def values(self):
        return list(self._entries.values())

    def _hit(self):
        self.hits += 1
        self._name_totals["hits"] += 1
        telemetry.counter("compile.cache_hits").inc()

    def get_or_build(self, key, build):
        """The program cached under `key`; on a miss, ``build()`` makes it
        (its seconds counted; a program that captures later counts its
        capture through `capture_stream`'s ``owner``)."""
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._hit()
                return fn
            self.misses += 1
            self._name_totals["misses"] += 1
            telemetry.counter("compile.cache_misses").inc()
            if self.hits > 0 and self._entries:
                _blame_miss(self.name, key, self._entries)
            t0 = time.perf_counter()
            fn = build()
            try:
                fn.compile_cache = self
            except AttributeError:
                pass
            self._entries[key] = fn
        dt = time.perf_counter() - t0
        _note_seconds(None, dt)
        self.compile_seconds += dt
        self._name_totals["compile_seconds"] += dt
        _entries_gauge()
        _audit_record(self, key, fn)
        return fn

    def entry_cost(self, key):
        """``{"flops", "bytes_accessed"}`` of one entry (`measure_cost`),
        or None when the entry is gone or was built with the observatory
        off."""
        cost = getattr(self._entries.get(key), "cost", None)
        if not cost:
            return None
        return {"flops": cost["flops"],
                "bytes_accessed": cost["bytes_accessed"]}

    def entry_dtype(self, key):
        """The dominant dtype of one entry's storages ("float32" when not
        counted): the observatory picks the matmul peak by it."""
        cost = getattr(self._entries.get(key), "cost", None)
        return cost["dtype"] if cost else "float32"

    def memory_stats(self):
        """One row per entry with a cost record: ``{key, flops,
        bytes_accessed, dtype, captures}``."""
        rows = []
        for key, prog in list(self._entries.items()):
            cost = getattr(prog, "cost", None)
            if cost:
                rows.append(dict(cost, key=repr(key),
                                 captures=getattr(prog, "captures", 0)))
        return rows

    def clear(self):
        """Drop every program (their graphs go with them)."""
        with self._lock:
            self._entries.clear()
        _entries_gauge()

    def snapshot(self):
        return {"name": self.name, "entries": len(self._entries),
                "hits": self.hits, "misses": self.misses,
                "compile_seconds": self.compile_seconds}


def all_caches():
    """Live `CompileCache` instances."""
    with _caches_lock:
        return list(_caches)


def stats():
    """Aggregate ``{entries, hits, misses, compile_seconds}`` over live
    caches, plus a per-cache breakdown."""
    per = [c.snapshot() for c in all_caches()]
    return {"entries": sum(p["entries"] for p in per),
            "hits": sum(p["hits"] for p in per),
            "misses": sum(p["misses"] for p in per),
            "compile_seconds": sum(p["compile_seconds"] for p in per),
            "caches": sorted(per, key=lambda p: p["name"])}


def name_totals():
    """``{name: {hits, misses, compile_seconds, entries}}`` for every cache
    name ever seen (the monotonic ledger behind `named_stats`); ``entries``
    counts the live programs. `telemetry.snapshot` embeds it as
    ``compile_caches``."""
    with _caches_lock:
        totals = {n: dict(t) for n, t in _name_totals.items()}
        live = list(_caches)
    for t in totals.values():
        t["entries"] = 0
    for c in live:
        t = totals.get(c.name)
        if t is not None:
            t["entries"] += len(c)
    return totals


def named_stats(name):
    """Every cache ever named `name`: ``hits``, ``misses`` and
    ``compile_seconds`` monotonic over the process's life, so deltas are
    safe to assert on; ``entries`` and ``caches`` describe the live
    ones."""
    per = [c.snapshot() for c in all_caches() if c.name == name]
    totals = _totals(name)
    return {"entries": sum(p["entries"] for p in per),
            "hits": totals["hits"], "misses": totals["misses"],
            "compile_seconds": totals["compile_seconds"],
            "caches": len(per)}


def _flatten_key(k, path=(), parent=None, out=None):
    """Leaf list ``[(path, parent container, value)]`` of one cache key
    (nested tuples by convention)."""
    if out is None:
        out = []
    if isinstance(k, (tuple, list)) and k:
        for i, v in enumerate(k):
            _flatten_key(v, path + (i,), k, out)
    else:
        out.append((path, parent, k))
    return out


def _axis_of(path, parent, old, new):
    """The key axis a differing leaf belongs to."""
    if isinstance(old, torch.dtype) or isinstance(new, torch.dtype):
        return "dtype"
    if isinstance(old, bool) or isinstance(new, bool):
        return "attr"
    if isinstance(old, int) and isinstance(new, int) and isinstance(
            parent, tuple) and all(isinstance(x, int) for x in parent):
        dim = path[-1] if path else 0
        return "shape(batch)" if dim == 0 else f"shape(dim{dim})"
    if isinstance(old, float) and isinstance(new, float):
        return "hyperparam"
    return "attr"


def _blame_miss(cache_name, key, entries):
    """A steady-state miss (the cache served hits before): diff ``key``
    against its nearest neighbour among the newest entries and publish
    the axis that changed, as the JAX package's blamer does."""
    new_flat = _flatten_key(key)
    best = None
    for old_key in list(entries)[-64:]:
        old = {p: v for p, _, v in _flatten_key(old_key)}
        diffs, score = [], 0
        for path, parent, v in new_flat:
            if path not in old:
                score += 1000
                continue
            try:
                same = bool(v == old[path]) and type(v) is type(old[path])
            except Exception:  # noqa: BLE001 - an exotic leaf
                same = v is old[path]
            if not same:
                score += 1
                diffs.append(_axis_of(path, parent, old[path], v))
        score += 1000 * abs(len(old) - len(new_flat))
        if best is None or score < best[0]:
            best = (score, diffs)
    if best is None:
        return
    axis = best[1][0] if best[1] else "structure"
    telemetry.counter("compile.blamed_misses").inc()
    telemetry.counter("compile.blame_axis." + axis.replace("(", "_")
                      .replace(")", "")).inc()
    from . import health

    if health._enabled:
        health.event("compile_blame", cache=cache_name, axis=axis,
                     axes=best[1][:4], key=repr(key)[:240])


def _audit_record(cache, key, prog):
    """Keep (a weak reference to) one built program for the audit dump,
    at most `_AUDIT_MAX` of them."""
    with _audit_lock:
        lk = (cache.name, repr(key))
        if lk in _audit_ledger or len(_audit_ledger) >= _AUDIT_MAX:
            return
        try:
            ref = weakref.ref(prog)
        except TypeError:
            def ref():
                return None
        _audit_ledger[lk] = {"cache": cache.name, "key": repr(key),
                             "prog": ref}


def audit_ledger():
    """The recorded ``(cache name, repr(key))`` pairs."""
    with _audit_lock:
        return sorted(_audit_ledger)


def dump_audit(dirpath):
    """Write one JSON file into ``dirpath`` with each audited entry's
    record: its cache, key, captures and cost where counted (None once
    its program is gone). Returns the path, or None when nothing was
    built."""
    with _audit_lock:
        recs = list(_audit_ledger.values())
    if not recs:
        return None
    entries = []
    for r in recs:
        prog = r["prog"]()
        entries.append({"cache": r["cache"], "key": r["key"],
                        "live": prog is not None,
                        "captures": getattr(prog, "captures", None),
                        "cost": getattr(prog, "cost", None)})
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, f"compile-audit-{os.getpid()}.json")
    tmp = path + ".tmp~"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "entries": entries}, f, indent=1)
    os.replace(tmp, path)
    return path


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

    `launch` runs the same call without the copy to the host: it returns
    the first output, a device tensor the next call overwrites, and leaves
    the caller to order its reads (the generation tick's overlap order
    copies it to a pinned buffer behind an event). The pinned inputs are
    written again only once the copies out of them have run (an event
    behind those copies).

    Calls must not overlap: the engine makes them under its tick lock.

    With the observatory on when the program first runs, that call (a
    warm-up call on the card) is counted by `measure_cost` into ``cost``;
    ``reads()`` returns the tensors `fn` reads besides its inputs (the
    parameters and the slab)."""

    def __init__(self, fn, shapes, device, pool=None, reads=None):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs = None
        self.captures = 0
        self.cost = None
        self._reads = reads
        self._pool = pool
        self._inputs = [torch.zeros(s, dtype=torch.int64, device=self.device)
                        for s in shapes]
        self._pinned = None
        self._copied = None      # event behind the last launch's input copies
        if self.device.type == "cuda":
            self._pinned = [torch.zeros(s, dtype=torch.int64).pin_memory()
                            for s in shapes]

    def __call__(self, *values):
        out = self.launch(*values)
        return out.cpu().numpy() if out.is_cuda else out.numpy()

    def launch(self, *values):
        """Write the inputs and run (on a card: replay) the program without
        waiting for it. Returns the first output, on the device."""
        if self._pinned is None:
            for buf, val in zip(self._inputs, values):
                buf.copy_(torch.as_tensor(np.asarray(val), dtype=torch.int64))
            with torch.inference_mode():
                self.outputs = self._first_or_call()
            return self.outputs[0]
        if self._copied is not None:
            # the last launch's copies out of the pinned inputs must have
            # run before they are written again
            self._copied.synchronize()
        for pin, buf, val in zip(self._pinned, self._inputs, values):
            pin.numpy()[...] = val
            buf.copy_(pin, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.outputs[0]

    def _first_or_call(self):
        """One eager call of `fn`, counted into ``cost`` when it is the
        first with the observatory on."""
        if self.cost is None and observatory._enabled:
            out, self.cost = measure_cost(
                lambda: self.fn(*self._inputs),
                list(self._inputs) + list(self._reads() if self._reads
                                          else ()))
            return out
        return self.fn(*self._inputs)

    def _capture(self):
        def warm_up():
            for _ in range(WARMUP_CALLS):
                self._first_or_call()

        with torch.inference_mode():
            self.graph, self.outputs = capture(
                lambda: self.fn(*self._inputs), self.device, self._pool,
                warm_up=warm_up, owner=self)
        self.captures += 1
