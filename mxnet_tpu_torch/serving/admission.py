"""Admission control: a bounded request queue with backpressure.

The port of `mxnet_tpu/serving/admission.py`, cut to what the generation
engine uses: the serving errors, `Request` and the FIFO `AdmissionQueue`
with its synchronous `QueueFullError` bound (`MXNET_SERVING_MAX_QUEUE`),
the per-tick deadline sweep (`expire`) and the graceful drain (`close`:
`ServerClosedError` for new work, queued work still handed out). Not
ported: the QoS ordering and quotas, the blocking batch flush of the
request-level batcher (`get_batch`, request splitting), telemetry and the
health journal.
"""
from __future__ import annotations

import collections
import threading
import time

from ..base import MXNetError, getenv, register_env

__all__ = ["AdmissionQueue", "Request", "ServingError", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError"]

register_env("MXNET_SERVING_MAX_QUEUE", 1024,
             "admission-queue depth bound: serving submit() fast-rejects "
             "with QueueFullError once this many requests are waiting")


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
    ``time.monotonic()`` instant or None; ``payload`` is the owner's (a
    generation session)."""

    __slots__ = ("arrays", "rows", "future", "deadline", "payload")

    def __init__(self, arrays, rows, future, deadline=None, payload=None):
        self.arrays = arrays
        self.rows = int(rows)
        self.future = future
        self.deadline = deadline
        self.payload = payload


class AdmissionQueue:
    """Bounded FIFO of :class:`Request`. Requests are handed out whole, in
    the order they came; one whose future already resolved is dropped
    unrun."""

    def __init__(self, max_depth=None):
        self._max_depth = int(getenv("MXNET_SERVING_MAX_QUEUE")
                              if max_depth is None else max_depth)
        if self._max_depth < 1:
            raise MXNetError("serving queue depth must be >= 1, got "
                             f"{self._max_depth}")
        self._q = collections.deque()
        self._cond = threading.Condition()
        self._closed = False

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
        """Admit `req` or reject NOW (QueueFullError, ServerClosedError).
        Never blocks: backpressure is a synchronous signal, not a stall."""
        with self._cond:
            if self._closed:
                raise ServerClosedError(
                    "serving queue is closed; no new requests accepted")
            if len(self._q) >= self._max_depth:
                raise QueueFullError(
                    f"serving queue full ({len(self._q)} >= "
                    f"{self._max_depth} requests); shed load or raise "
                    "MXNET_SERVING_MAX_QUEUE")
            self._q.append(req)
            self._cond.notify()

    def kick(self):
        """Wake every waiter on the queue."""
        with self._cond:
            self._cond.notify_all()

    def get_batch_nowait(self, max_rows):
        """Pop whole requests, oldest first, while their rows fit in
        `max_rows` (the first whatever its size: the port never splits a
        request), without blocking. Returns ``(requests, reason)``,
        reason ``"inline"`` (``"drain"`` once closed), or ``(None, None)``
        when nothing is queued."""
        with self._cond:
            out, rows = [], 0
            while self._q:
                req = self._q[0]
                if req.future.done():
                    self._q.popleft()
                    continue
                if out and rows + req.rows > max_rows:
                    break
                self._q.popleft()
                out.append(req)
                rows += req.rows
                if rows >= max_rows:
                    break
            if not out:
                return None, None
            return out, ("drain" if self._closed else "inline")

    def expire(self, now=None):
        """Remove and return every queued request whose deadline has passed
        (skipping resolved futures). The caller fails them; the generation
        engine sweeps this once per tick, so a stream that will never get a
        slot in time fails NOW instead of wedging its iterator."""
        now = time.monotonic() if now is None else now
        with self._cond:
            expired = [r for r in self._q
                       if r.deadline is not None and now >= r.deadline
                       and not r.future.done()]
            for r in expired:
                self._q.remove(r)
        return expired

    def close(self):
        """Stop admitting; wake every waiter so the worker can drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
