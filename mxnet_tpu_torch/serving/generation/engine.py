"""GenerationEngine: token-level continuous batching over a KV slot slab.

The port of `mxnet_tpu/serving/generation/engine.py`, its plain lane:

* **slot-based session store**: a preallocated KV slab
  ``[max_slots, layers, heads, max_len, head_dim]``
  (`TransformerLM.init_cache`) whose shape and storage NEVER change:
  admitting a session is a prefill write into a free slot, evicting one
  clears host metadata;
* **continuous scheduling**: every tick sweeps deadlines, admits queued
  prompts into free slots (a prefill each, padded up a bucket ladder) and
  runs ONE decode step over the whole slab, so every live session advances
  one greedy token together; finished, EOS and expired sessions leave
  mid-stream and queued ones take their slots;
* **build once**: the engine's ``CompileCache("generation")`` holds one
  program per prefill bucket and exactly one decode program. On the card
  each is captured once as a CUDA graph over the slab and static input
  buffers, and every later call refills the inputs and replays it: the
  counterpart of the JAX engine's compile-once executables. `warm` builds
  them all ahead of traffic; steady state builds nothing.

Not ported yet: the prefix cache, the speculative lane, QoS park and
resume, weight swaps, the overlap tick order, telemetry, tracing and the
health probes.
"""
from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from ...base import MXNetError, getenv, register_env
from ...compile_cache import CompileCache, GraphProgram
from ..admission import AdmissionQueue, DeadlineExceededError, Request
from ..predictor import bucket_ladder
from .session import GenerationStream

__all__ = ["GenerationEngine", "prefill_ladder"]

register_env("MXNET_GENERATION_SLOTS", 8,
             "KV-slab slot count per generation engine: the max number of "
             "concurrently-decoding sessions (one fused decode_step covers "
             "the whole slab each tick)")
register_env("MXNET_GENERATION_MAX_LEN", 256,
             "KV-slab sequence capacity per slot (prompt + generated "
             "tokens); bounds per-slot memory at "
             "2*layers*heads*max_len*head_dim*dtype bytes")
register_env("MXNET_GENERATION_PREFILL_BUCKETS", "",
             "prefill-length bucket ladder (comma-separated ints, each a "
             "built prefill program); empty = powers of two from 8 up "
             "to MXNET_GENERATION_MAX_LEN")
register_env("MXNET_GENERATION_TICK_BUDGET_MS", 10.0,
             "max milliseconds one scheduler tick spends admitting queued "
             "prefills before the fused decode runs again (>= 1 admission "
             "per tick when slots are free, so queues always drain)")

_logger = logging.getLogger(__name__)


def prefill_ladder(buckets, max_len):
    """Normalize a prefill bucket spec (None ->
    ``MXNET_GENERATION_PREFILL_BUCKETS``; empty -> powers of two up to
    `max_len`) into an ascending tuple capped at `max_len`."""
    if buckets is None:
        buckets = getenv("MXNET_GENERATION_PREFILL_BUCKETS")
    if not (buckets.strip() if isinstance(buckets, str) else buckets):
        b, buckets = 8, []
        while b < max_len:
            buckets.append(b)
            b *= 2
        buckets.append(max_len)
    out = bucket_ladder(buckets, env_var="MXNET_GENERATION_PREFILL_BUCKETS")
    return tuple(sorted({min(int(b), int(max_len)) for b in out}))


class _Session:
    """Engine-side state of one admitted (or queued) generation."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "deadline", "stream",
                 "slot", "generated")

    def __init__(self, prompt, max_new_tokens, eos_id, deadline, stream):
        self.prompt = prompt            # np.int32 [n]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline = deadline
        self.stream = stream
        self.slot = None
        self.generated = 0


class GenerationEngine:
    """Continuous-batching autoregressive server over one model.

    Parameters
    ----------
    model : TransformerLM
        The port's model, on the device it serves from (``cuda``, or the
        CPU when it was built with ``device="cpu"``).
    params : dict, optional
        None serves the model's own parameters. A state dict in the port's
        names (as `models.params_from_jax` returns it) is loaded into the
        model first.
    max_slots / max_len / buckets / tick_budget_ms :
        Overrides of the ``MXNET_GENERATION_*`` knobs; `max_len` is capped
        at the model's positional range.
    max_queue : int, optional
        Intake bound (default ``MXNET_SERVING_MAX_QUEUE``).
    eos_id : int, optional
        Default end-of-sequence token for sessions that pass none.
    start : bool
        Start the scheduler's worker thread; with False the caller drives
        ticks (``_tick_once``) and blocking stream iterators assist.
    """

    def __init__(self, model, params=None, max_slots=None, max_len=None,
                 buckets=None, max_queue=None, tick_budget_ms=None,
                 eos_id=None, start=True):
        if params is not None:
            model.load_state_dict(params)
        self._model = model
        self._slots = int(getenv("MXNET_GENERATION_SLOTS")
                          if max_slots is None else max_slots)
        if self._slots < 1:
            raise MXNetError(f"need >= 1 slot, got {self._slots}")
        self._max_len = min(int(getenv("MXNET_GENERATION_MAX_LEN")
                                if max_len is None else max_len),
                            model.cfg.max_len)
        if self._max_len < 2:
            raise MXNetError(f"max_len must be >= 2, got {self._max_len}")
        self._slab_len = self._max_len
        self._buckets = prefill_ladder(buckets, self._max_len)
        budget_ms = (getenv("MXNET_GENERATION_TICK_BUDGET_MS")
                     if tick_budget_ms is None else tick_budget_ms)
        self._tick_budget_s = float(budget_ms) / 1e3
        self._eos_id = eos_id

        self._cache = CompileCache("generation")
        # one memory pool for every graph of the engine: they replay one
        # at a time on one stream, so their intermediates can share it
        self._pool = (torch.cuda.graph_pool_handle()
                      if model.device.type == "cuda" else None)
        # the graphs keep the slab's pointers: it is never reallocated
        self._ck, self._cv = model.init_cache(self._slots, self._slab_len)
        # host-side slot metadata, mutated only under _tick_lock
        self._sessions = [None] * self._slots
        self._lengths = np.zeros(self._slots, np.int32)
        self._last_tok = np.zeros(self._slots, np.int32)
        self._live = 0

        self._queue = AdmissionQueue(max_queue)
        self._tick_lock = threading.Lock()
        self._work = threading.Condition()
        self._closed = False
        self.sessions_submitted = 0

        self._worker = None
        if start:
            self._worker = threading.Thread(
                target=self._loop, daemon=True,
                name="mxnet_tpu_torch.serving.generation.engine")
            self._worker.start()

    # -- properties ----------------------------------------------------------

    @property
    def max_slots(self):
        return self._slots

    @property
    def max_len(self):
        return self._max_len

    @property
    def prefill_buckets(self):
        return self._buckets

    @property
    def cache(self):
        """The engine's ``"generation"`` `CompileCache`: ``.misses`` is the
        exact number of programs built so far."""
        return self._cache

    @property
    def captures(self):
        """CUDA graphs captured so far (0 on the CPU)."""
        return sum(p.captures for p in self._cache.values())

    @property
    def live_slots(self):
        return self._live

    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def closed(self):
        return self._closed

    def kv_slab_bytes(self):
        """Device bytes the KV slab pins, keys and values."""
        return int(self._ck.nbytes) + int(self._cv.nbytes)

    def bucket_for(self, n):
        for b in self._buckets:
            if b >= n:
                return b
        return None

    # -- client API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens=64, eos_id=None, timeout=None):
        """Admit one prompt; returns a `GenerationStream` at once.
        `timeout` (seconds) is the SESSION deadline, checked every tick in
        the queue and mid-generation; expiry evicts the slot and fails the
        stream with `DeadlineExceededError`. Raises `QueueFullError` and
        `ServerClosedError` synchronously, and MXNetError on a prompt that
        is empty, holds a token outside the vocabulary (an index the card
        cannot clamp), or does not fit a bucket or the slab."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size < 1:
            raise MXNetError("empty prompt")
        vocab = self._model.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise MXNetError(f"prompt tokens must lie in [0, {vocab})")
        if prompt.size > self._buckets[-1]:
            raise MXNetError(
                f"prompt of {prompt.size} tokens exceeds the largest "
                f"prefill bucket {self._buckets[-1]}")
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if prompt.size + int(max_new_tokens) > self._max_len:
            raise MXNetError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slab capacity "
                f"{self._max_len} (MXNET_GENERATION_MAX_LEN)")
        deadline = (time.monotonic() + float(timeout)
                    if timeout is not None else None)
        stream = GenerationStream(self, prompt.size, max_new_tokens,
                                  deadline)
        sess = _Session(prompt, max_new_tokens,
                        self._eos_id if eos_id is None else eos_id,
                        deadline, stream)
        self._queue.put(Request([prompt], 1, stream._future,
                                deadline=deadline, payload=sess))
        with self._work:
            self.sessions_submitted += 1
            self._work.notify_all()
        return stream

    def generate(self, prompt, **kwargs):
        """Blocking convenience: submit and collect the full token list."""
        return list(self.submit(prompt, **kwargs))

    def warm(self, buckets=None):
        """Build every program ahead of traffic, counted exactly: one
        prefill per bucket and THE decode program; on the card each build
        is one capture. The prefill warms write garbage into a FREE slot
        (skipped, with a log, when the slab is full); the decode warm runs
        only while no session is live and writes to the slab's last row
        (`_tick_positions`), so warming never perturbs a session. Returns
        ``{"buckets", "compiles", "captures", "seconds",
        "cache_entries"}``."""
        buckets = (self._buckets if buckets is None
                   else tuple(sorted({int(b) for b in buckets})))
        t0 = time.perf_counter()
        with self._tick_lock:
            misses0, captures0 = self._cache.misses, self.captures
            free_list = self._free_slots()
            free = free_list[0] if free_list else None
            for b in buckets:
                if b not in self._buckets:
                    raise MXNetError(f"bucket {b} not in ladder "
                                     f"{self._buckets}")
                if free is None:
                    _logger.warning("generation warmup: slab full, skipping "
                                    "prefill warm for bucket %d", b)
                    continue
                self._prefill_fn(b)(np.zeros(b, np.int64), 1, free)
            if self._live == 0:
                self._decode_fn()(self._last_tok, self._tick_positions())
            compiles = self._cache.misses - misses0
            captures = self.captures - captures0
        return {"buckets": list(buckets), "compiles": compiles,
                "captures": captures,
                "seconds": time.perf_counter() - t0,
                "cache_entries": len(self._cache)}

    def close(self, timeout=None):
        """Graceful drain: stop admission (`ServerClosedError` for new
        submits), keep ticking until every admitted AND queued session
        completes, join the worker. Idempotent."""
        self._queue.close()
        self._closed = True
        with self._work:
            self._work.notify_all()
        if self._worker is not None and self._worker.is_alive():
            self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def stats(self):
        return {"cache": self._cache.snapshot(), "captures": self.captures,
                "buckets": list(self._buckets), "slots": self._slots,
                "live": self._live, "queued": len(self._queue),
                "sessions": self.sessions_submitted,
                "max_len": self._max_len,
                "kv_slab_bytes": self.kv_slab_bytes()}

    # -- built programs ------------------------------------------------------

    def _prefill_fn(self, bucket):
        """The bucket's prefill program: (padded tokens, length, slot) ->
        the greedy next token, writing the slot's rows of the slab."""
        model, ck, cv = self._model, self._ck, self._cv

        def fn(tokens, length, slot):
            logits, _, _ = model.prefill(ck, cv, tokens, length, slot)
            return logits.argmax().reshape(1), logits

        def build():
            return GraphProgram(fn, [(bucket,), (1,), (1,)], model.device,
                                self._pool)

        return self._cache.get_or_build(
            ("prefill", bucket, self._slots, self._slab_len), build)

    def _decode_fn(self):
        """THE decode program: one step over the whole slab, (tokens,
        positions) -> the greedy token of every slot. Its key never
        changes, so admission and eviction only ever hit it."""
        model, ck, cv = self._model, self._ck, self._cv

        def fn(tokens, positions):
            logits, _, _ = model.decode_step(ck, cv, tokens, positions)
            return logits.argmax(-1), logits

        def build():
            return GraphProgram(fn, [(self._slots,), (self._slots,)],
                                model.device, self._pool)

        return self._cache.get_or_build(
            ("decode", self._slots, self._slab_len), build)

    # -- scheduler -----------------------------------------------------------

    def _has_work(self):
        return self._live > 0 or len(self._queue) > 0

    def _loop(self):
        while True:
            with self._work:
                while not self._closed and not self._has_work():
                    self._work.wait()
                if self._closed and not self._has_work():
                    return
            self._tick_once()

    def _assist_once(self):
        """Caller-runs assist (stream iterators call this while waiting):
        run one tick inline if the tick lock is free. Returns True when a
        tick ran (or there was nothing to do), False when another thread
        holds the lock."""
        if not self._tick_lock.acquire(blocking=False):
            return False
        try:
            if self._has_work():
                self._tick()
            return True
        finally:
            self._tick_lock.release()

    def _tick_once(self):
        with self._tick_lock:
            if self._has_work():
                self._tick()

    def _tick(self):
        """One scheduler tick (tick lock held), in lockstep order: sweep
        deadlines, admit prefills into free slots, run ONE decode over the
        slab. A tick never raises: a failure fails the live sessions in
        band and zeroes the slab in place, so the captured graphs stay
        valid and no session reads rows a failed program half wrote."""
        try:
            now = time.monotonic()
            for req in self._queue.expire(now):
                self._fail_queued(req.payload, now)
            for slot, sess in enumerate(self._sessions):
                if (sess is not None and sess.deadline is not None
                        and now >= sess.deadline):
                    self._evict(slot, "deadline", DeadlineExceededError(
                        f"session deadline passed after {sess.generated} "
                        f"generated token(s)"))
            self._admit()
            self._decode()
        except Exception as e:  # noqa: BLE001 - never strand a session
            _logger.exception("generation tick failed")
            for slot, sess in enumerate(self._sessions):
                if sess is not None:
                    self._evict(slot, "error", e)
            self._ck.zero_()
            self._cv.zero_()
        if self._has_work():
            # an assist tick pops the queue before the session is live; a
            # worker that re-checked _has_work() in that window went back
            # to sleep, so any tick that leaves work pending wakes it
            with self._work:
                self._work.notify_all()

    def _free_slots(self):
        return [i for i in range(self._slots) if self._sessions[i] is None]

    def _tick_positions(self):
        """Write positions for the decode program: a live slot's length,
        and the slab's LAST row for every other slot. Dead slots still get
        a K/V row written every tick (the fixed shape computes all slots),
        so their garbage goes to row ``slab_len - 1``, which no session
        reads before its own write (a session ends before its length
        reaches the slab's). Every position must be in range, since the
        card faults where JAX clamps: checked here."""
        pos = self._lengths.copy()
        safe = self._slab_len - 1
        for i, s in enumerate(self._sessions):
            if s is None:
                pos[i] = safe
        if pos.min() < 0 or pos.max() > safe:
            raise MXNetError(f"decode positions {pos} outside the slab's "
                             f"rows [0, {safe}]")
        return pos

    def _claim_slot(self, free):
        """Pop a free slot for a session, or None when the slab is full."""
        return free.pop(0) if free else None

    def _admit(self):
        """Move queued sessions into free slots (prefill), oldest first,
        until the slab is full, the queue is empty or the tick budget is
        spent: at least one admission per tick when a slot is free."""
        free = self._free_slots()
        if free:
            self._admit_into(free, time.perf_counter())

    def _admit_into(self, free, t0):
        while True:
            slot = self._claim_slot(free)
            if slot is None:
                return
            batch, _ = self._queue.get_batch_nowait(1)
            if not batch:
                free.append(slot)
                return
            sess = batch[0].payload
            now = time.monotonic()
            if sess.deadline is not None and now >= sess.deadline:
                self._fail_queued(sess, now)
                free.append(slot)
                continue
            n = int(sess.prompt.size)
            bucket = self.bucket_for(n)
            try:
                # submit() keeps these in range; the card would fault
                if not (bucket is not None and bucket <= self._slab_len
                        and 0 <= slot < self._slots):
                    raise MXNetError(f"prompt of {n} tokens in bucket "
                                     f"{bucket} at slot {slot} does not fit "
                                     f"the slab")
                padded = np.zeros(bucket, np.int64)
                padded[:n] = sess.prompt
                tok = int(self._prefill_fn(bucket)(padded, n, slot)[0])
            except Exception as e:
                # the popped session is in neither the queue nor a slot:
                # fail its stream here, or it is stranded; re-raise so the
                # tick resets the slab
                sess.stream._fail(e)
                raise
            sess.slot = slot
            self._sessions[slot] = sess
            self._lengths[slot] = n
            self._last_tok[slot] = tok
            self._live += 1
            self._deliver(sess, tok)
            # the first token may already end the session; its slot goes
            # straight back on the free list
            self._maybe_finish(slot)
            if self._sessions[slot] is None:
                free.append(slot)
            if time.perf_counter() - t0 > self._tick_budget_s:
                return

    def _decode(self):
        """ONE step over the whole slab: every live session advances one
        token; dead slots ride along as masked garbage."""
        pending = self._decode_dispatch()
        if pending is not None:
            self._decode_commit(pending)

    def _decode_dispatch(self):
        """Run the decode program on the slab's current tokens and
        positions. Returns ``(slots, their sessions, tokens)`` for
        `_decode_commit`, or None when no slot is live."""
        if self._live == 0:
            return None
        toks = self._decode_fn()(self._last_tok, self._tick_positions())
        slots = [s for s, sess in enumerate(self._sessions)
                 if sess is not None]
        return slots, [self._sessions[s] for s in slots], toks

    def _decode_commit(self, pending):
        """Deliver one token per still-live slot, advance its length and
        evict the sessions that ended."""
        slots, snap, toks = pending
        for slot, dispatched in zip(slots, snap):
            sess = self._sessions[slot]
            if sess is None or sess is not dispatched:
                continue
            # the token we fed now occupies position lengths[slot]
            self._lengths[slot] += 1
            tok = int(toks[slot])
            self._last_tok[slot] = tok
            self._deliver(sess, tok)
            self._maybe_finish(slot)

    # -- delivery / eviction -------------------------------------------------

    def _deliver(self, sess, tok):
        sess.generated += 1
        sess.stream._push(tok)

    def _maybe_finish(self, slot):
        """Evict the slot if its session just reached a terminal state."""
        sess = self._sessions[slot]
        if sess.eos_id is not None and self._last_tok[slot] == sess.eos_id:
            self._evict(slot, "eos")
        elif sess.generated >= sess.max_new_tokens:
            self._evict(slot, "finished")
        elif self._lengths[slot] + 1 > self._max_len:
            # no room to write the next token's K/V
            self._evict(slot, "max_len")

    def _evict(self, slot, reason, exc=None):
        """Free the slot: host metadata only; the KV rows stay as masked
        garbage until the next occupant's prefill rewrites them."""
        sess = self._sessions[slot]
        self._sessions[slot] = None
        self._lengths[slot] = 0
        self._last_tok[slot] = 0
        self._live -= 1
        if reason not in ("eos", "finished"):
            _logger.info("generation slot %d evicted (%s) after %d token(s)",
                         slot, reason, sess.generated)
        if exc is not None:
            sess.stream._fail(exc)
        else:
            sess.stream._finish()

    def _fail_queued(self, sess, now):
        """Deadline death while still queued: no slot to free, only the
        stream to unblock."""
        sess.stream._fail(DeadlineExceededError(
            f"session waited {now - sess.stream.submitted_at:.3f}s in "
            "queue, past its deadline"))
