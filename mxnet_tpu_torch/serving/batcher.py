"""DynamicBatcher: coalesce concurrent requests into padded bucket batches.
The port of `mxnet_tpu/serving/batcher.py`.

One request of 3 rows and one of 5 cost the same single graph replay as
their 8-row union, so under concurrent traffic the scheduler's job is to
merge callers:

* callers ``submit()`` requests (any row count) and get a
  `concurrent.futures.Future`;
* one worker thread pops rows FIFO from the `AdmissionQueue` when enough
  rows queue up to fill the largest bucket or the oldest request has
  waited ``MXNET_SERVING_MAX_WAIT_MS``. The request at the batch boundary
  is SPLIT so a max-batch flush is exactly full; oversize requests stream
  through the same way, max_batch rows per flush;
* the coalesced rows are concatenated, padded up to the smallest bucket
  that fits, computed ONCE, and sliced back per request; the pieces of a
  split request are reassembled in row order;
* a blocking `predict` that finds the worker idle runs the queued batches
  itself (caller-runs assist) instead of paying two thread hand-offs;
* with ``MXNET_OVERLAP`` (default on) the worker stages its next full
  flush (pop, concatenate, pad on the card) between the current flush's
  dispatch and its wait.

Failures: expired requests fail with `DeadlineExceededError` before
compute; transient errors (``Predictor.retry_on``, default OSError) are
retried with `resilience.retry_call` backoff but never past the earliest
deadline in the batch; other errors fail every request of the batch.
``close()`` drains: admitted requests complete, new ones get
`ServerClosedError`.

Observability, each plane gated on its module's ``_enabled``: the
``serving.*`` series (requests, batches, ``batch_rows`` / ``batch_slots``,
whose ratio is the derived ``serving.batch_fill_ratio``, flush reasons,
queue time, ``e2e_us``, errors and timeouts); a span tree a request
(``serving.request`` with its admission, queue, execute and reassembly
children, a flow arrow to the batch that ran it), across the worker, an
assisting caller and split requests; and the flush's wall time as the
observatory's ``serving`` lane. A request's ``tenant`` reaches its
`admission.Request`: with a QoS registry active the queue pops by class
and deadline and `submit` enforces the tenant's quotas
(`qos.QuotaExceededError`, synchronously).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future

from .. import ndarray as nd
from .. import observatory, telemetry, tracing
from ..base import getenv, register_env
from ..io.staging import overlap_enabled
from ..log import get_logger
from ..resilience import retry_call
from .admission import AdmissionQueue, DeadlineExceededError, Request
from .health import attach_batcher, queue_ready

__all__ = ["DynamicBatcher"]

register_env("MXNET_SERVING_MAX_WAIT_MS", 5.0,
             "dynamic micro-batcher flush deadline: a queued request waits "
             "at most this long for co-batchable traffic before its batch "
             "is flushed short")


class DynamicBatcher:
    """Queue-and-coalesce front end over a `Predictor`.

    Parameters
    ----------
    predictor : Predictor
        The bucket-bound engine; its largest bucket is the coalescing
        target (``max_batch``).
    max_wait_ms : float, optional
        Flush deadline override (default ``MXNET_SERVING_MAX_WAIT_MS``).
    max_queue : int, optional
        Admission bound override (default ``MXNET_SERVING_MAX_QUEUE``).
    retries / backoff_s :
        Transient-failure retry budget handed to `resilience.retry_call`
        (what counts as transient is ``predictor.retry_on``).
    """

    def __init__(self, predictor, max_wait_ms=None, max_queue=None,
                 retries=2, backoff_s=0.02):
        self._predictor = predictor
        wait_ms = (getenv("MXNET_SERVING_MAX_WAIT_MS")
                   if max_wait_ms is None else max_wait_ms)
        self._max_wait_s = float(wait_ms) / 1e3
        self._max_batch = predictor.max_batch
        self._admission = AdmissionQueue(max_queue)
        self._retries = retries
        self._backoff_s = backoff_s
        self._logger = get_logger("mxnet_tpu_torch.serving")
        # one assisting caller at a time; the pieces of a split request can
        # then be delivered from two runner threads, so delivery state is
        # guarded by _result_lock
        self._assist = threading.Lock()
        self._result_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._loop, daemon=True,
            name="mxnet_tpu_torch.serving.batcher")
        self._worker.start()
        self.health_name = attach_batcher(self)

    # -- client API ----------------------------------------------------------

    @property
    def predictor(self):
        return self._predictor

    @property
    def queue_depth(self):
        return len(self._admission)

    def healthy(self):
        """Liveness: (ok, detail); False only when the worker thread died
        while the batcher still accepts work."""
        if not self._worker.is_alive() and not self._admission.closed:
            return False, "batcher worker thread died"
        return True, "ok"

    def ready(self):
        """Readiness: (ok, reason). Closed (draining), a predictor neither
        warmed nor bound by traffic, or an intake queue above the health
        watermark report not ready."""
        if self._admission.closed:
            return False, "closed (draining)"
        p = self._predictor
        if not getattr(p, "_warmed", True) and not getattr(p, "_execs", True):
            return False, "predictor warmup not run"
        return queue_ready(self._admission)

    def submit(self, data, timeout=None, tenant=None):
        """Enqueue one request; returns a Future resolving to what
        ``predictor.predict(data)`` would return. ``timeout`` (seconds)
        sets its deadline: expired in the queue (or before a retry), the
        future fails with `DeadlineExceededError`. ``tenant`` names the
        QoS tenant (its class and quotas; ignored while QoS is off).
        Raises `QueueFullError`, `ServerClosedError` and, QoS on,
        `qos.QuotaExceededError` synchronously. Any row count is accepted:
        requests larger than the biggest bucket stream through successive
        batches and reassemble."""
        arrays = self._predictor._as_arrays(data)
        n = int(arrays[0].shape[0])
        deadline = (time.monotonic() + float(timeout)
                    if timeout is not None else None)
        fut = Future()
        req = Request(arrays, n, fut, deadline=deadline, tenant=tenant)
        if tracing._enabled:
            # the request's root span, finished by the thread that
            # resolves the future (the worker, an assisting caller, or
            # this one on a synchronous rejection)
            req.span = tracing.begin("serving.request", cat="serving",
                                     rows=n)
            sub = req.span.child("serving.admission")
            # the flow arrow starts before put(): once the request is
            # queued the worker may end the flow at once
            tracing.flow_start(req.span.span_id, name="serving.request")
            try:
                self._admission.put(req)
            except Exception as e:
                sub.set(error=repr(e)).finish()
                req.span.set(error=repr(e)).finish()
                raise
            sub.finish()
        else:
            self._admission.put(req)
        if telemetry._enabled:
            telemetry.counter("serving.requests").inc()
        return fut

    def predict(self, data, timeout=None, tenant=None):
        """Blocking ``submit(...).result()`` with CALLER-RUNS assistance: a
        caller that finds the assist slot free drains queued batches inline
        (its own and whatever coalesced behind it) instead of paying two
        thread hand-offs to the worker."""
        fut = self.submit(data, timeout=timeout, tenant=tenant)
        if self._assist.acquire(blocking=False):
            self._admission.assist_active = True
            try:
                while not fut.done():
                    batch, reason = self._admission.get_batch_nowait(
                        self._max_batch)
                    if batch is None:
                        break  # our request is mid-compute on the worker
                    self._run_batch_guarded(batch, reason)
            finally:
                self._admission.assist_active = False
                self._assist.release()
                self._admission.kick()  # anything left is the worker's
        return fut.result()

    def warmup(self, buckets=None):
        """Build every bucket ahead of traffic: see
        :func:`mxnet_tpu_torch.serving.warmup`."""
        from .warmup import warmup

        return warmup(self._predictor, buckets=buckets)

    def close(self, timeout=None):
        """Graceful drain: stop admission, let the worker finish every
        request already accepted, join it. Idempotent. Deregisters the
        health probes."""
        from .. import health

        self._admission.close()
        if self._worker.is_alive():
            self._worker.join(timeout)
        health.unregister(self.health_name)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- worker --------------------------------------------------------------

    def _loop(self):
        # overlap lane: while a flush runs on the card the worker prepares
        # the NEXT one (`_execute_prep` calls `_stage_next` between the
        # dispatch and the wait); a staged prep runs on the next turn,
        # after a deadline re-sweep
        staged = None
        while True:
            if staged is not None:
                prep, staged = staged, None
                prep = self._resweep_staged(prep)
                if prep is None:
                    continue
                staged = self._execute_prep_guarded(prep, stage=True)
                continue
            batch, reason = self._admission.get_batch(
                self._max_batch, self._max_wait_s)
            if batch is None:
                return
            staged = self._run_batch_guarded(batch, reason, stage=True)

    def _run_batch_guarded(self, batch, reason, stage=None):
        """`_run_batch` that never strands a request: an unexpected error
        in batching or delivery fails every popped future instead of
        killing the worker (or, on the assist path, leaking the batch
        mates' futures). Returns the prep staged mid-flight, if any."""
        try:
            return self._run_batch(batch, reason, stage=stage)
        except Exception as e:  # noqa: BLE001
            for r in batch:
                if not r.origin.future.done():
                    self._fail(r, e)
            self._logger.error("serving batch failed unexpectedly: %r", e)
            return None

    def _execute_prep_guarded(self, prep, stage=None):
        """Never-strand wrapper for running an already prepared flush."""
        try:
            return self._execute_prep(prep, stage=stage)
        except Exception as e:  # noqa: BLE001
            for r in prep["live"]:
                if not r.origin.future.done():
                    self._fail(r, e)
            self._logger.error("serving batch failed unexpectedly: %r", e)
            return None

    def _fail(self, req, exc, timeout=False):
        """Fail the request a piece belongs to (once: later pieces of a
        split request are dropped unrun by the queue's done() check)."""
        orig = req.origin
        with self._result_lock:
            if orig.future.done():
                return
            if telemetry._enabled:
                telemetry.counter(
                    "serving.timeouts" if timeout else "serving.errors").inc()
            orig.future.set_exception(exc)
            if orig.span is not None:
                orig.span.set(error=repr(exc), timeout=timeout).finish()

    def _deliver(self, req, sliced, done_ts):
        """Hand a computed piece its rows; a split request resolves once
        every piece has arrived, reassembled in row order."""
        orig = req.origin
        with self._result_lock:
            if orig.future.done():
                return
            t0r = (tracing.now_us()
                   if tracing._enabled and orig.span is not None else None)
            if req.offset == 0 and req.rows == orig.total_rows:
                orig.future.set_result(self._predictor._wrap_outputs(sliced))
            else:
                if orig.parts is None:
                    orig.parts = []
                orig.parts.append((req.offset, req.rows, sliced))
                if sum(r for _, r, _ in orig.parts) < orig.total_rows:
                    return
                orig.parts.sort(key=lambda p: p[0])
                merged = [nd.concatenate([p[2][k] for p in orig.parts],
                                         axis=0)
                          for k in range(len(sliced))]
                orig.parts = None
                orig.future.set_result(self._predictor._wrap_outputs(merged))
            if t0r is not None:
                # the request resolved on this thread: close its tree
                tracing.emit_span("serving.reassembly", t0r,
                                  tracing.now_us() - t0r, cat="serving",
                                  parent=orig.span, rows=orig.total_rows)
                orig.span.finish()
            if telemetry._enabled:
                telemetry.histogram("serving.e2e_us").record(
                    (done_ts - orig.enqueued_at) * 1e6)

    def _run_batch(self, reqs, reason, stage=None):
        prep = self._prepare_batch(reqs, reason)
        if prep is None:
            return None
        return self._execute_prep(prep, stage=stage)

    def _prepare_batch(self, reqs, reason, staged=False, requeued=False):
        """Everything on the host a flush needs BEFORE dispatch: the
        deadline filter, the queue records and spans, the concatenated
        feed, and for a staged prep (overlap lane) the pad up to the
        bucket, so the predictor's own pad is a no-op. Returns a prep
        dict, or None when nothing stayed live."""
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now >= r.deadline:
                self._fail(r, DeadlineExceededError(
                    f"request waited {now - r.enqueued_at:.3f}s in queue, "
                    "past its deadline"), timeout=True)
            elif not r.origin.future.done():
                live.append(r)
        if not live:
            return None
        if telemetry._enabled and not requeued:
            for r in live:
                telemetry.histogram("serving.time_in_queue_us").record(
                    (now - r.enqueued_at) * 1e6)
        rows = sum(r.rows for r in live)
        bucket = self._predictor.bucket_for(rows)
        if tracing._enabled:
            # each request's queue span (submit to this pop) and the flow
            # arrow landing in this batch, once a request
            t_pop = tracing.now_us()
            for r in live:
                sp = r.origin.span
                if sp is None:
                    continue
                if not r.traced_queue:
                    r.traced_queue = True
                    tracing.emit_span("serving.queue", sp.t0, t_pop - sp.t0,
                                      cat="serving", parent=sp,
                                      offset=r.offset, rows=r.rows)
                if not r.origin.flow_ended:
                    r.origin.flow_ended = True
                    tracing.flow_end(sp.span_id, name="serving.request")
        feeds = []
        for i in range(len(self._predictor.data_names)):
            parts = [r.arrays[i] for r in live]
            feeds.append(parts[0] if len(parts) == 1
                         else nd.concatenate(parts, axis=0))
        if staged:
            from ..io.io import pad_arrays

            feeds, _ = pad_arrays(feeds, bucket)
        earliest = min((r.deadline for r in live
                        if r.deadline is not None), default=None)
        return {"live": live, "reason": reason, "rows": rows,
                "bucket": bucket, "feeds": feeds, "earliest": earliest,
                "staged": staged, "t0": time.perf_counter()}

    def _resweep_staged(self, prep):
        """A staged prep sat out one flush: sweep its deadlines again
        before dispatch. Expired requests fail here; the others are
        prepared again (their rows no longer pad the batch)."""
        now = time.monotonic()
        live = prep["live"]
        expired = [r for r in live
                   if r.deadline is not None and now >= r.deadline]
        if not expired and all(not r.origin.future.done() for r in live):
            return prep
        for r in expired:
            self._fail(r, DeadlineExceededError(
                "request expired while staged for the next flush"),
                timeout=True)
        rest = [r for r in live if r not in expired]
        if not rest:
            return None
        return self._prepare_batch(rest, prep["reason"], staged=True,
                                   requeued=True)

    def _stage_next(self):
        """Pop and prepare the NEXT flush while the current one runs on
        the card. Only a FULL flush already queued is staged: a partial
        queue keeps its ``max_wait`` coalescing window."""
        try:
            if self._admission._rows < self._max_batch:
                return None
            batch, reason = self._admission.get_batch_nowait(self._max_batch)
            if batch is None:
                return None
            if telemetry._enabled:
                telemetry.counter("serving.staged_flushes").inc()
            return self._prepare_batch(batch, reason, staged=True)
        except Exception as e:  # noqa: BLE001 — never fail the IN-FLIGHT
            # batch because the next one failed to stage
            self._logger.error("serving stage-ahead failed: %r", e)
            return None

    def _execute_prep(self, prep, stage=None):
        """Dispatch, (overlap) stage the next flush, wait, deliver.
        Returns the prep staged mid-flight, or None."""
        live, reason = prep["live"], prep["reason"]
        bucket, feeds = prep["bucket"], prep["feeds"]
        earliest, rows = prep["earliest"], prep["rows"]
        # a staged prep's wall starts at dispatch (its prepare was hidden);
        # a lockstep one's includes the prepare it paid inline
        t_wall0 = time.perf_counter() if prep["staged"] else prep["t0"]
        staged_box = [None]
        # an instance whose `_run` was patched over (a test's gate) keeps
        # the lockstep call, so the patch sees every forward
        stage_fn = self._stage_next if (
            stage and overlap_enabled()
            and "_run" not in self._predictor.__dict__) else None
        state = {"first": stage_fn is not None}

        def attempt():
            # a retry never runs past the batch's earliest deadline:
            # DeadlineExceededError is not in retry_on, so raising it here
            # ends the retry loop at once
            if earliest is not None and time.monotonic() >= earliest:
                raise DeadlineExceededError(
                    "deadline passed before a (re)try could run")
            if state["first"]:
                state["first"] = False
                pending = self._predictor._run_dispatch(bucket, feeds)
                staged_box[0] = stage_fn()
                return self._predictor._run_wait(pending)
            return self._predictor._run(bucket, feeds)

        with tracing.span("serving.batch", cat="serving", rows=rows,
                          bucket=bucket, reason=reason,
                          staged=prep["staged"]):
            t_exec0 = tracing.now_us() if tracing._enabled else 0.0
            try:
                outs = retry_call(attempt,
                                  desc=f"serving forward bucket={bucket}",
                                  retries=self._retries,
                                  backoff=self._backoff_s,
                                  retry_on=self._predictor.retry_on)
            except DeadlineExceededError as e:
                now = time.monotonic()
                expired, rest = [], []
                for r in live:
                    (expired if r.deadline is not None and now >= r.deadline
                     else rest).append(r)
                for r in expired:
                    self._fail(r, e, timeout=True)
                if rest:
                    # the others still have time: run them again without
                    # the expired requests' rows
                    self._run_batch(rest, reason)
                return staged_box[0]
            except Exception as e:  # noqa: BLE001 - fail the batch, serve on
                for r in live:
                    self._fail(r, e)
                return staged_box[0]
            if tracing._enabled:
                # each request's view of the shared compute window, so
                # every request tree is complete on its own
                t_exec1 = tracing.now_us()
                for r in live:
                    sp = r.origin.span
                    if sp is not None:
                        tracing.emit_span("serving.execute", t_exec0,
                                          t_exec1 - t_exec0, cat="serving",
                                          parent=sp, bucket=bucket,
                                          batch_rows=rows)
            if telemetry._enabled:
                telemetry.counter("serving.batches").inc()
                telemetry.counter("serving.batch_rows").inc(rows)
                telemetry.counter("serving.batch_slots").inc(bucket)
                telemetry.counter(f"serving.flush_{reason}").inc()
                telemetry.histogram("serving.batch_occupancy").record(rows)
            off = 0
            done_ts = time.monotonic()
            for r in live:
                self._deliver(r, [o[off:off + r.rows] for o in outs],
                              done_ts)
                off += r.rows
            if observatory._enabled:
                # the flush's wall; the predictor observed the program and
                # its device time
                observatory.observe("serving",
                                    wall_s=time.perf_counter() - t_wall0)
        return staged_box[0]
