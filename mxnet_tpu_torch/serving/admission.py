"""Admission control: a bounded request queue with backpressure.

The port of `mxnet_tpu/serving/admission.py`: the serving errors,
`Request` and the FIFO `AdmissionQueue` with its synchronous
`QueueFullError` bound (`MXNET_SERVING_MAX_QUEUE`), the flush policy of
the request-level batcher (`get_batch`: a full largest bucket, or the
oldest request's wait; the boundary request split so a full flush is
exactly full), the non-blocking pop of an assisting caller and of the
generation engine (`get_batch_nowait`), the per-tick deadline sweep
(`expire`) and the graceful drain (`close`: `ServerClosedError` for new
work, queued work still handed out), with the ``<prefix>.queue_depth``
gauge and ``<prefix>.rejected`` counter (telemetry) and the
``admission_reject`` journal event (health).

With a QoS registry active (`qos.active`, captured when the queue is
built) the pop order becomes ``(class rank, earliest deadline, enqueue
time)``, batch requests aging into standard rank after
``MXNET_QOS_AGING_S``, and `put` also enforces the tenants' quotas
(`qos.QuotaExceededError`, the ``qos.rejected`` / ``qos.admitted``
counters and the ``qos_quota_reject`` event). Without one every path
here is the FIFO queue, unchanged.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import health, telemetry
from ..base import MXNetError, getenv, register_env

__all__ = ["AdmissionQueue", "Request", "ServingError", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError"]

register_env("MXNET_SERVING_MAX_QUEUE", 1024,
             "admission-queue depth bound: serving submit() fast-rejects "
             "with QueueFullError once this many requests are waiting")

# the qos module, bound at the first queue's construction: qos.py imports
# this module for ServingError, so a top-level import would cycle
_qos = None


class ServingError(MXNetError):
    """Base class of serving-plane failures."""


class QueueFullError(ServingError):
    """Backpressure: the admission queue is at ``MXNET_SERVING_MAX_QUEUE``
    requests. Raised synchronously from ``submit()``: the cheap signal to
    shed load now rather than time out later."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed before a result could be computed."""


class ServerClosedError(ServingError):
    """``submit()`` after ``close()``: the server is draining or stopped."""


class Request:
    """One admitted request: its input arrays, its row count and the future
    that delivers its result. ``deadline`` is an absolute
    ``time.monotonic()`` instant or None; ``enqueued_at`` is stamped at
    construction and drives the flush timer; ``payload`` is the owner's (a
    generation session).

    A request may be SPLIT at a batch boundary (`AdmissionQueue._split`)
    so that every max-batch flush is exactly full: the popped head piece
    points back at the original through ``parent`` and ``offset``, and the
    original is cut down to its tail rows in place (keeping its queue
    position, future and enqueue time). The batcher reassembles the pieces
    by offset before it resolves the future. ``span`` is the request's
    root span (tracing on); ``traced_queue`` and ``flow_ended`` mark the
    queue span and the flow arrow emitted once. ``tenant`` names the QoS
    tenant (None = the default class); ``qos_rank`` is its class rank,
    stamped by `put` while QoS is on; ``qos_exempt`` skips the quotas (a
    migrated session, charged at its first admission).
    """

    __slots__ = ("arrays", "rows", "future", "deadline", "enqueued_at",
                 "parent", "offset", "total_rows", "parts", "span",
                 "traced_queue", "flow_ended", "payload", "tenant",
                 "qos_rank", "qos_exempt")

    def __init__(self, arrays, rows, future, deadline=None, payload=None,
                 tenant=None):
        self.arrays = arrays
        self.rows = int(rows)
        self.future = future
        self.deadline = deadline
        self.payload = payload
        self.tenant = tenant
        self.qos_rank = None        # class rank stamped at put() (QoS on)
        self.qos_exempt = False     # skip quotas (migrated, already charged)
        self.enqueued_at = time.monotonic()
        self.parent = None          # set on split-off head pieces
        self.offset = 0             # row offset within the original request
        self.total_rows = self.rows  # original size (pieces keep parent's)
        self.parts = None           # on the original: delivered pieces
        self.span = None            # the root span (tracing on)
        self.traced_queue = False   # queue span emitted for THIS piece
        self.flow_ended = False     # flow arrow landed (on the origin)

    @property
    def origin(self):
        """The request whose future this piece resolves (itself, unless
        split off)."""
        return self.parent if self.parent is not None else self


class AdmissionQueue:
    """Bounded FIFO of :class:`Request` with the batch-flush wait logic
    (class-ordered while a QoS registry is active)."""

    def __init__(self, max_depth=None, metric_prefix="serving"):
        self._max_depth = int(getenv("MXNET_SERVING_MAX_QUEUE")
                              if max_depth is None else max_depth)
        self._prefix = metric_prefix
        if self._max_depth < 1:
            raise MXNetError("serving queue depth must be >= 1, got "
                             f"{self._max_depth}")
        global _qos
        if _qos is None:
            from . import qos as _qos_module

            _qos = _qos_module
        self._qos = _qos.active()
        self._q = collections.deque()
        self._rows = 0
        self._cond = threading.Condition()
        self._closed = False
        # set (by the batcher, under its assist lock) while a blocking
        # caller drains inline: put() then skips the worker wake-up, since
        # the assistant pops the request anyway and a woken worker would
        # only convoy with it on the interpreter lock. The assistant kick()s
        # the worker for anything it leaves behind.
        self.assist_active = False

    def __len__(self):
        with self._cond:
            return len(self._q)

    @property
    def closed(self):
        return self._closed

    @property
    def max_depth(self):
        return self._max_depth

    def put(self, req):
        """Admit `req` or reject NOW (QueueFullError, ServerClosedError
        and, QoS on, QuotaExceededError for a tenant over its quota).
        Never blocks: backpressure is a synchronous signal, not a stall."""
        with self._cond:
            if self._closed:
                raise ServerClosedError(
                    "serving queue is closed; no new requests accepted")
            spec = None
            if self._qos is not None:
                spec = self._qos.spec_for(req.tenant)
                req.qos_rank = spec.rank
                if not req.qos_exempt:
                    try:
                        self._qos.check_admit(req.tenant)
                    except Exception as e:
                        if telemetry._enabled:
                            telemetry.counter(
                                f"{self._prefix}.rejected").inc()
                            telemetry.counter(_qos.labeled_metric(
                                "qos.rejected", spec)).inc()
                        if health._enabled:
                            health.event("qos_quota_reject",
                                         prefix=self._prefix,
                                         tenant=spec.name, cls=spec.cls,
                                         error=repr(e))
                        raise
            if len(self._q) >= self._max_depth:
                if telemetry._enabled:
                    telemetry.counter(f"{self._prefix}.rejected").inc()
                    if spec is not None:
                        telemetry.counter(_qos.labeled_metric(
                            "qos.rejected", spec)).inc()
                if health._enabled:
                    health.event("admission_reject", prefix=self._prefix,
                                 depth=len(self._q))
                raise QueueFullError(
                    f"serving queue full ({len(self._q)} >= "
                    f"{self._max_depth} requests); shed load or raise "
                    "MXNET_SERVING_MAX_QUEUE")
            self._q.append(req)
            self._rows += req.rows
            if telemetry._enabled:
                telemetry.gauge(f"{self._prefix}.queue_depth").set(
                    len(self._q))
                if spec is not None:
                    telemetry.counter(_qos.labeled_metric(
                        "qos.admitted", spec)).inc()
                    self._qos_depth_gauges()
            if not self.assist_active:
                self._cond.notify()

    def kick(self):
        """Wake the worker (an exiting assistant calls this so requests it
        left queued are not stranded behind a skipped notify)."""
        with self._cond:
            self._cond.notify_all()

    def _qos_sort(self, now=None):
        """Reorder the queue by (effective class rank, earliest deadline,
        enqueue time), under the held condition right before a pop: aging
        makes the effective rank a function of NOW. Stable, so requests
        of equal priority stay FIFO. No-op while QoS is off."""
        if self._qos is None or len(self._q) < 2:
            return
        now = time.monotonic() if now is None else now
        reg, inf = self._qos, float("inf")
        self._q = collections.deque(sorted(
            self._q,
            key=lambda r: (reg.effective_rank(r.qos_rank, r.enqueued_at,
                                              now),
                           r.deadline if r.deadline is not None else inf,
                           r.enqueued_at)))

    def _qos_depth_gauges(self):
        """The per-class queue-depth gauges (held condition; QoS and
        telemetry on)."""
        counts = {cls: 0 for cls in _qos.CLASSES}
        for r in self._q:
            rank = (self._qos.default_rank if r.qos_rank is None
                    else r.qos_rank)
            counts[_qos.CLASSES[rank]] += 1
        for cls, n in counts.items():
            telemetry.gauge(telemetry.labeled(
                "qos.queue_depth", **{"class": cls})).set(n)

    def peek(self):
        """The request the next pop would hand out (class order while QoS
        is on), skipping resolved futures: the generation engine's
        preemption probe. None when nothing is pending."""
        with self._cond:
            self._qos_sort()
            for r in self._q:
                if not r.origin.future.done():
                    return r
            return None

    def weighted_depth(self):
        """The queue depth weighted by the tenants' QoS weights (plain
        ``len`` while QoS is off): the autoscale demand's share."""
        with self._cond:
            if self._qos is None:
                return float(len(self._q))
            return float(sum(self._qos.weight(r.tenant) for r in self._q))

    def get_batch(self, max_rows, max_wait_s):
        """Block until a flushable batch is ready and pop it.

        Returns ``(requests, reason)``, reason ``"full"`` (queued rows
        reached ``max_rows``), ``"timeout"`` (the oldest request waited
        ``max_wait_s``) or ``"drain"`` (queue closed, handing out the
        rest), or ``(None, None)`` once closed AND empty: the worker's exit
        signal. The pop is FIFO in row order (`_pop`)."""
        with self._cond:
            while True:
                while not self._q and not self._closed:
                    self._cond.wait()
                if not self._q:
                    return None, None  # closed and drained
                if self._closed:
                    reason = "drain"
                elif self._rows >= max_rows:
                    reason = "full"
                else:
                    oldest = self._q[0].enqueued_at
                    if self._qos is not None:
                        # class order can bury the oldest request behind
                        # the head; the flush timer still honours its age
                        oldest = min(r.enqueued_at for r in self._q)
                    remaining = oldest + max_wait_s - time.monotonic()
                    if remaining > 0:
                        self._cond.wait(timeout=remaining)
                        continue
                    reason = "timeout"
                out = self._pop(max_rows)
                if out:
                    return out, reason
                # everything queued was already-failed pieces: wait again

    def get_batch_nowait(self, max_rows):
        """Non-blocking pop for an assisting caller or the generation
        engine: whatever is queued right now, reason ``"inline"``
        (``"drain"`` once closed), or ``(None, None)`` when the queue is
        empty."""
        with self._cond:
            out = self._pop(max_rows)
            if not out:
                return None, None
            return out, ("drain" if self._closed else "inline")

    def _pop(self, max_rows):
        """FIFO row-order pop under the held condition: whole requests
        while they fit, the boundary request split at ``max_rows``; pieces
        of a request whose future already resolved (an earlier piece
        failed) are dropped unrun. With QoS on, the order is the class
        order `_qos_sort` just imposed."""
        self._qos_sort()
        out, rows = [], 0
        while self._q and rows < max_rows:
            req = self._q[0]
            if req.origin.future.done():
                self._q.popleft()
                self._rows -= req.rows
                continue
            if rows + req.rows <= max_rows:
                self._q.popleft()
                self._rows -= req.rows
                rows += req.rows
                out.append(req)
            else:
                k = max_rows - rows
                out.append(self._split(req, k))
                self._rows -= k
                rows += k
        if telemetry._enabled:
            telemetry.gauge(f"{self._prefix}.queue_depth").set(len(self._q))
            if self._qos is not None:
                self._qos_depth_gauges()
        return out

    def expire(self, now=None):
        """Remove and return every queued request whose deadline has passed
        (skipping resolved futures). The caller fails them; the generation
        engine sweeps this once per tick, so a stream that will never get a
        slot in time fails NOW instead of wedging its iterator."""
        now = time.monotonic() if now is None else now
        with self._cond:
            expired = [r for r in self._q
                       if r.deadline is not None and now >= r.deadline
                       and not r.origin.future.done()]
            for r in expired:
                self._q.remove(r)
                self._rows -= r.rows
            if expired and telemetry._enabled:
                telemetry.gauge(f"{self._prefix}.queue_depth").set(
                    len(self._q))
                if self._qos is not None:
                    self._qos_depth_gauges()
        return expired

    @staticmethod
    def _split(req, k):
        """Carve the first ``k`` rows of ``req`` into a piece pointing back
        at the original; ``req`` keeps the tail in place (same future,
        deadline and enqueue time)."""
        head = Request([a[0:k] for a in req.arrays], k, req.future,
                       deadline=req.deadline, tenant=req.tenant)
        head.qos_rank = req.qos_rank
        head.enqueued_at = req.enqueued_at
        head.parent = req.origin
        head.offset = req.offset
        head.total_rows = req.total_rows
        req.arrays = [a[k:] for a in req.arrays]
        req.rows -= k
        req.offset += k
        return head

    def close(self):
        """Stop admitting; wake every waiter so the worker can drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
