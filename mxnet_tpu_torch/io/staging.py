"""Staged input batches: the host-overlap half of the pipeline. The port of
`mxnet_tpu/io/staging.py`.

A lockstep training step pays the batch's pad, cast and copy to the card
on the critical path while the card waits. `DeviceStager` moves that work
off it: while step *t* runs, one staging thread pads and casts batch
*t + 1*, writes it into pinned host buffers and copies it to device
buffers on a side CUDA stream, then records an event. The consumer
(`Module.fit`'s deferred metric lane) takes the staged feed, makes its
own stream wait on that event, and copies it into the fixed tensors its
captured step reads. The other lanes (the serving batcher's stage-ahead,
the generation tick's launch-then-bookkeep order) live with each loop;
this module owns the switch and the ring's discipline:

* **buffer lifetime**: the ring owns at most ``depth`` sets of buffers
  (pinned host and device tensors per feed name), allocated once and
  reused: a set goes back to the ring at `DeviceStager.retire`, after the
  step that read it, and its next fill waits on the card for an event
  recorded then, behind that step's reads, and on the host for its last
  copies out of the pinned buffers; `stage` refuses new work while every
  slot is staged or in flight, and the feed's tensors are marked as used
  by the consuming stream (``record_stream``) for when the ring drops
  them;
* **identity hand-off**: `DeviceStager.take` matches the batch OBJECT; a
  consumer that shows up with another batch misses and runs its lockstep
  path, and so does one whose ``guard`` fails (its executor was rebound);
* **no silent fallback on the card**: a slot whose preparation failed
  (a pinned allocation, the side stream, the copy) raises its error at
  `take`, on the consumer's thread; it never turns into a lockstep step.

On the CPU the same protocol runs without a stream or pinned memory.
``MXNET_OVERLAP=0`` turns every overlap lane off at once (fit, serving,
generation) and restores the lockstep order; ``MXNET_STAGING_BUFFERS``
sizes the ring (at least 2: one slot in flight, one staging);
`STAGE_MIN_BYTES` is the smallest batch `fit` stages.
"""
from __future__ import annotations

import threading
import time as _time

from .. import analysis, telemetry
from ..base import getenv, register_env

__all__ = ["overlap_enabled", "STAGE_MIN_BYTES", "DeviceStager",
           "host_copies"]

register_env("MXNET_OVERLAP", 1,
             "overlap host work (batch staging, deferred metric reads, "
             "serving and generation bookkeeping) with the card's "
             "in-flight work; 0 = lockstep")
register_env("MXNET_STAGING_BUFFERS", 2,
             "DeviceStager ring depth: staged-but-unretired batches the "
             "input pipeline may hold on the device (min 2)")
# the smallest batch (bytes at the bound dtypes) `fit` stages. On an
# NVIDIA H100 80GB HBM3 at 700 W, a 0.5-4 MiB host batch of `bench.py`'s
# MLP ran 0.41-0.91 x as fast staged as in lockstep and a 16-64 MiB one
# 1.01-1.33 x (``tools/torch_overlap_sweep.py``): below this the staging
# thread's hand-off under the interpreter lock costs more than the copy
# it hides
STAGE_MIN_BYTES = 8 << 20


def overlap_enabled():
    """One switch for every overlap lane (fit, serving, generation)."""
    return bool(int(getenv("MXNET_OVERLAP") or 0))


def host_copies(arrays):
    """Copies of ``arrays`` (NDArrays) on the host, made without waiting:
    on a card each goes to a pinned buffer on the current stream, and one
    event is recorded behind the copies. Returns (the copies as NDArrays,
    the event or None). Waiting on the event waits for the work queued
    before the copies only, where a plain copy to the host would wait for
    everything queued on the stream since (the next step's replay)."""
    import torch

    from ..ndarray import NDArray

    if not any(a._data.is_cuda for a in arrays):
        return list(arrays), None
    out = []
    for a in arrays:
        src = a._data.detach()
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src, non_blocking=True)
        out.append(NDArray(pinned))
    event = torch.cuda.Event()
    event.record()
    return out, event


class _Buffers:
    """One slot's buffers, kept by the ring and reused by later slots once
    theirs retires: per feed name, the tensor on the consumer's device and,
    on a card, the pinned host tensor it is copied from; the event behind
    its last copies (side stream) and the one recorded on the consumer's
    stream when it was retired."""

    __slots__ = ("host", "dev", "copied", "released")

    def __init__(self):
        self.host, self.dev = {}, {}
        self.copied = self.released = None


class _Slot:
    """One ring entry: the batch it was staged for, the prepared feed, the
    buffers it lives in and its lifecycle (ready -> in flight -> retired)."""

    __slots__ = ("batch", "prep", "guard", "after", "feed", "pad", "bufs",
                 "error", "event", "ready", "in_flight")

    def __init__(self, batch, prep, guard, after):
        self.batch = batch
        self.prep = prep
        self.guard = guard
        self.after = after
        self.feed = None
        self.pad = 0
        self.bufs = None
        self.error = None
        self.event = None
        self.ready = False
        self.in_flight = False


class DeviceStager:
    """Bounded ring of staged input batches fed by one thread.

    Protocol (main thread unless noted)::

        stager.stage(batch, prep)      # queued; the thread runs prep()
        ...launch step t...
        hit = stager.take(batch)       # (feed, pad) or None
        ...step consuming the feed completes (its metric read)...
        stager.retire(batch)           # its slot's buffers free

    ``prep(put)`` runs on the staging thread and returns ``(feed, pad)``;
    ``put(name, array, dtype)`` copies ``array`` (host or device, numpy,
    tensor or NDArray) into the slot's buffer for ``name`` on the
    consumer's device, cast to ``dtype``, and returns that buffer. The
    buffers belong to the ring: at most ``depth`` sets, each reused by a
    later slot once its own has retired. ``device`` picks the ring's side
    stream: on a CUDA device, host values are written into pinned buffers
    and copied to the device buffers on a side stream (``torch.cuda.
    Stream``), every slot's copies end in an event that `take` makes the
    consumer's current stream wait on, and a reused set first waits for
    the consumer's reads of it (an event recorded at `retire`). ``guard``
    (optional) is checked again at `take`; False drops the slot.
    """

    def __init__(self, name="io.stager", depth=None, device="cpu"):
        import torch

        if depth is None:
            depth = int(getenv("MXNET_STAGING_BUFFERS") or 2)
        self._depth = max(2, int(depth))
        self._device = torch.device(device)
        # the side stream: a failure to make it raises here, never a
        # silent lockstep
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device.type == "cuda" else None)
        # analysis-tracked, so MXNET_DEBUG_SYNC sees the staging thread
        self._cv = analysis.make_condition(name)
        self._name = name
        self._slots = []          # FIFO: staged and in flight, oldest first
        self._queue = []          # staged, not yet prepared: thread input
        self._pool = []           # buffer sets free for the next slots
        self._thread = None
        self._closed = False

    @property
    def depth(self):
        return self._depth

    @property
    def stream(self):
        """The side stream the copies run on (None on the CPU)."""
        return self._stream

    def occupancy(self):
        """(staged or preparing, in flight) slot counts."""
        with self._cv:
            return (sum(1 for s in self._slots if not s.in_flight),
                    sum(1 for s in self._slots if s.in_flight))

    # -- producer side -------------------------------------------------------

    def stage(self, batch, prep, guard=None, block=False):
        """Queue ``batch`` for staging; True when accepted. A full ring
        (every slot staged or in flight: the consumer is ``depth`` steps
        behind) refuses the batch unless ``block``: that step then runs
        its lockstep feed, while reusing a live buffer never happens."""
        import torch

        if self._closed:
            return False
        after = None
        if self._stream is not None:
            # what this thread's stream wrote so far (a batch on the card)
            # is read by the side stream only after it
            after = torch.cuda.Event()
            after.record()
        with self._cv:
            if block:
                while len(self._slots) >= self._depth and not self._closed:
                    self._cv.wait(timeout=0.05)
            if self._closed or len(self._slots) >= self._depth:
                if telemetry._enabled:
                    telemetry.counter("io.stage_ring_full").inc()
                return False
            slot = _Slot(batch, prep, guard, after)
            self._slots.append(slot)
            self._queue.append(slot)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True)
                self._thread.start()
            self._cv.notify_all()
        return True

    def _put_into(self, bufs):
        """The ``put`` of a slot whose buffers are ``bufs`` (staging
        thread, inside the side stream's context on a card)."""
        import numpy as np
        import torch

        def put(name, array, dtype):
            src = getattr(array, "_data", array)
            if not torch.is_tensor(src):
                src = torch.from_numpy(np.ascontiguousarray(src))
            src = src.detach()
            shape = tuple(src.shape)
            dev = bufs.dev.get(name)
            if dev is None or tuple(dev.shape) != shape or \
                    dev.dtype != dtype:
                dev = bufs.dev[name] = torch.empty(shape, dtype=dtype,
                                                   device=self._device)
            if self._stream is None or src.is_cuda:
                dev.copy_(src)
                return dev
            host = bufs.host.get(name)
            if host is None or tuple(host.shape) != shape or \
                    host.dtype != dtype:
                host = bufs.host[name] = torch.empty(shape, dtype=dtype,
                                                     pin_memory=True)
            host.copy_(src)                 # the cast, off the loop
            dev.copy_(host, non_blocking=True)
            return dev

        return put

    def _run(self):
        """The staging thread: prepare each queued slot in turn."""
        import torch

        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(timeout=0.2)
                if self._closed and not self._queue:
                    return
                slot = self._queue.pop(0)
                bufs = self._pool.pop(0) if self._pool else _Buffers()
            t0 = _time.perf_counter()
            feed, pad, event, error = None, 0, None, None
            try:
                if self._stream is None:
                    feed, pad = slot.prep(self._put_into(bufs))
                else:
                    if bufs.copied is not None:
                        # its pinned buffers: the last copies out are done
                        bufs.copied.synchronize()
                    with torch.cuda.stream(self._stream):
                        if bufs.released is not None:
                            self._stream.wait_event(bufs.released)
                        if slot.after is not None:
                            self._stream.wait_event(slot.after)
                        feed, pad = slot.prep(self._put_into(bufs))
                    event = torch.cuda.Event()
                    event.record(self._stream)
                    bufs.copied = event
            except Exception as e:  # noqa: BLE001 - raised again at take()
                error, bufs = e, None
            if telemetry._enabled:
                telemetry.counter("io.stage_prep_us_total").inc(
                    int((_time.perf_counter() - t0) * 1e6))
            with self._cv:
                slot.feed, slot.pad, slot.event = feed, pad, event
                slot.bufs, slot.error = bufs, error
                slot.ready = True
                self._cv.notify_all()

    # -- consumer side -------------------------------------------------------

    def _release(self, slot):
        """Drop ``slot`` from the ring and give its buffers back (lock
        held). On a card their reuse waits for an event recorded now on
        the consumer's stream, behind every read of them queued so far."""
        import torch

        self._slots.remove(slot)
        bufs, slot.bufs, slot.feed = slot.bufs, None, None
        if bufs is not None and not self._closed:
            if self._stream is not None:
                bufs.released = torch.cuda.Event()
                bufs.released.record(
                    torch.cuda.current_stream(self._device))
            self._pool.append(bufs)
        self._cv.notify_all()

    def take(self, batch):
        """The staged ``(feed, pad)`` of this exact batch object, or None.

        Waits (counted into ``io.stage_wait_us_total``) while the thread
        still prepares it. On a card the consumer's current stream is made
        to wait on the slot's copy event and every feed tensor is marked
        as used by that stream, so nothing reads a half-copied buffer and
        the allocator keeps its memory until the reading step is done. The
        feed's tensors are the ring's buffers: read (copy) them before the
        slot retires. A miss or a failed guard returns None and drops the
        slot; a failed preparation raises its error."""
        import torch

        with self._cv:
            slot = next((s for s in self._slots
                         if not s.in_flight and s.batch is batch), None)
            if slot is None:
                return None
            t0 = _time.perf_counter()
            waited = False
            while not slot.ready:
                waited = True
                self._cv.wait(timeout=0.2)
            if waited and telemetry._enabled:
                telemetry.counter("io.stage_wait_us_total").inc(
                    int((_time.perf_counter() - t0) * 1e6))
            if slot.error is not None:
                self._release(slot)
                raise slot.error
            if slot.guard is not None and not slot.guard():
                self._release(slot)
                if telemetry._enabled:
                    telemetry.counter("overlap.fallback_batches").inc()
                return None
            slot.in_flight = True
        if slot.event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(slot.event)
            for t in slot.feed.values():
                data = getattr(t, "_data", t)
                if torch.is_tensor(data) and data.is_cuda:
                    data.record_stream(consumer)
        if telemetry._enabled:
            telemetry.counter("overlap.staged_batches").inc()
        return slot.feed, slot.pad

    def retire(self, batch=None):
        """Free the in-flight slot of ``batch`` (None: the oldest one) and
        give its buffers back to the ring: call once the step that took it
        has read them (its deferred metric applied). Returns False when no
        such slot is in flight."""
        with self._cv:
            for s in self._slots:
                if s.in_flight and (batch is None or s.batch is batch):
                    self._release(s)
                    return True
            return False

    def close(self):
        """Drop every slot and buffer and stop the staging thread (fit's
        teardown)."""
        with self._cv:
            self._closed = True
            self._queue = []
            self._slots = []
            self._pool = []
            self._cv.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)
