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
* **prefix cache with in-slab forking** (``MXNET_GENERATION_PREFIX_CACHE``):
  a refcounted radix trie (`prefix_cache.py`) maps prompt prefixes to
  slab slots holding their K/V. A prompt whose prefix is cached is
  admitted by ONE fork program (the source slot's rows copied onto the
  session's) and a suffix prefill of the unmatched tail
  (`TransformerLM.prefill_at`); sessions outrank cached entries for slots
  (LRU eviction of unpinned entries above a retention floor of one);
* **speculative decoding** (``MXNET_GENERATION_SPEC_K``): a draft
  (`speculative.py`) proposes k tokens a live slot and ONE verify program
  (`TransformerLM.verify_step`, k + 1 unrolled decode steps) checks them
  all; the engine commits the longest agreeing prefix plus the target's
  own next token, so greedy output is bit-exact with the plain lane. The
  slab carries k scratch rows for the verify's writes;
* **live weight swaps** (`swap_weights`): new admissions run the new
  weights while every live session finishes on the version it was
  admitted under. The programs read the model's parameters in place, so
  the engine keeps a copy of every pinned version and, on a tick where
  more than one version is live, writes each cohort's copy into the
  parameters before its replay and the current one back after;
* **engines sharing a model**: each engine serves its own weights (the
  ``params`` it was given are its version 0). The model remembers which
  set its parameters hold; an engine whose set is not the one bound writes
  its set in under the model's lock before it replays, first keeping a
  copy of the displaced set where that was its only copy, and engines on
  one model tick one at a time;
* **multi-tenant QoS** (a `qos.TenantRegistry` active at construction):
  the queue pops by class and deadline, and the slab grows
  ``MXNET_QOS_PARK_SLOTS`` park rows past session capacity. When a
  higher-class request heads the queue and no slot is free, the youngest
  batch session is PREEMPTED: THE fork program copies its rows into a
  park row and its slot frees; once no higher-class request waits, the
  oldest parked session is forked back into a free slot and continues,
  greedy bit-exact with a run the preemption never touched (on a slab of
  the same shape). Parked sessions keep their deadlines, and
  `eject_parked` / `adopt` move them to another replica, which
  re-prefills their whole context. With QoS off the slab, the programs
  and their keys are those of an engine without the lane;
* **overlap tick order** (``MXNET_OVERLAP``, on by default): the decode
  is launched FIRST and its tokens copied to a pinned host buffer behind
  an event; the queue expiry, deadline sweeps and admission (with
  preemption) run while the card decodes, and only then does the tick
  wait on the event and commit. A slot whose session was evicted,
  preempted or replaced inside that window drops its token (the commit
  checks the session's identity), so streams equal the lockstep order's;
* **build once**: the engine's ``CompileCache("generation")`` holds one
  program per prefill bucket and exactly one decode (or verify) program,
  plus, per lane, one suffix prefill a bucket and THE fork program (for
  the prefix cache and the park region alike), and a checkpoint draft's
  own prefills and step. On the card each is captured once as a CUDA
  graph over the slab and static input buffers, and every later call
  refills the inputs and replays it: the counterpart of the JAX engine's
  compile-once executables. `warm` builds them all ahead of traffic;
  steady state, swaps and preemptions included, builds nothing.

Observability, each plane gated on its module's ``_enabled``: the
``serving.generation.*`` telemetry series (ticks, ``tick_us``, tokens,
``ttft_us``, prefills, evictions, and the ``prefix.*`` / ``spec.*``
counters, which the attributes ``prefix_hits``, ``prefix_misses``,
``spec_committed`` and ``spec_verified_slots`` also keep); a span tree a
tick (``generation.tick`` with its admit and decode children, observed by
`tracing.tick_recorder`) and one a session; the tick beacon that
`attach_engine` arms; the tick's `observatory.observe` with CUDA events
around the decode on a card; and the slab in the memory census
(``kv_cache``). Every record sits in the host code around the replays:
a captured graph runs no Python. With QoS on, the labeled ``qos.*``
series (tokens, TTFT, preemptions, resumes, ejections, adoptions) and
the ``qos_preempt`` / ``qos_resume`` events join them.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref

import numpy as np
import torch

from ... import health, memory, observatory, telemetry, tracing
from ...base import MXNetError, getenv, register_env
from ...compile_cache import CompileCache, GraphProgram
from ...io import staging as _staging
from ...models.convert import state_like
from .. import qos
from ..admission import AdmissionQueue, DeadlineExceededError, Request
from ..health import attach_engine, queue_ready
from ..predictor import bucket_ladder
from . import speculative
from .prefix_cache import RadixPrefixCache
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
register_env("MXNET_GENERATION_PREFIX_CACHE", False,
             "cache prompt-prefix KV in free slab slots (refcounted radix "
             "trie): admission of a prompt with a cached prefix runs one "
             "slot-to-slot fork + a suffix-only prefill instead of "
             "a full-prompt prefill")
register_env("MXNET_GENERATION_PREFIX_MIN_TOKENS", 8,
             "shortest prompt prefix worth forking from (or inserting "
             "into) the prefix cache — below this a full prefill is "
             "cheaper than the fork dispatch")

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


class _ParamSet:
    """One set of parameter values an engine serves. ``tensors`` is a copy
    on the model's device, or None while the model's parameters are the
    set's only copy (it is bound, and nothing displaced it since)."""

    __slots__ = ("tensors", "__weakref__")

    def __init__(self, tensors=None):
        self.tensors = tensors


def _model_state(model):
    """The per-model record engines share: the lock every program read of
    the parameters runs under, and (a weak reference to) the `_ParamSet`
    the parameters hold."""
    st = model.__dict__.get("_generation_state")
    if st is None:
        st = model.__dict__.setdefault(
            "_generation_state", {"lock": threading.RLock(), "bound": None})
    return st


def _bound_set(state):
    ref = state["bound"]
    return ref() if ref is not None else None


class _Session:
    """Engine-side state of one admitted (or queued) generation."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "deadline", "stream",
                 "slot", "generated", "prefix_len", "version", "span",
                 "tenant", "qos_rank", "admit_seq")

    def __init__(self, prompt, max_new_tokens, eos_id, deadline, stream,
                 tenant=None):
        self.prompt = prompt            # np.int32 [n]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline = deadline
        self.stream = stream
        self.slot = None
        self.generated = 0
        self.prefix_len = 0             # cached tokens forked at admission
        self.version = 0                # weights version pinned at admission
        self.span = None                # the session's span (tracing on)
        self.tenant = tenant            # QoS tenant (None = default class)
        self.qos_rank = None            # class rank stamped at admission
        self.admit_seq = 0              # admission order: preemption parks
        #                                 the YOUNGEST batch session


def _host_copy(t):
    """A parameter as a numpy array (bf16 as float32, which holds it
    exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


class GenerationEngine:
    """Continuous-batching autoregressive server over one model.

    Parameters
    ----------
    model : TransformerLM
        The port's model, on the device it serves from (``cuda``, or the
        CPU when it was built with ``device="cpu"``).
    params : dict, optional
        The weights this engine serves, a state dict in the port's names
        (as `models.params_from_jax` returns it) or the JAX package's.
        None serves the values the model's parameters hold now. Engines
        over one model each serve their own set (the module docstring).
    max_slots / max_len / buckets / tick_budget_ms :
        Overrides of the ``MXNET_GENERATION_*`` knobs; `max_len` is capped
        at the model's positional range less `spec_k`.
    max_queue : int, optional
        Intake bound (default ``MXNET_SERVING_MAX_QUEUE``).
    eos_id : int, optional
        Default end-of-sequence token for sessions that pass none.
    start : bool
        Start the scheduler's worker thread; with False the caller drives
        ticks (``_tick_once``) and blocking stream iterators assist.
    prefix_cache / prefix_min_tokens :
        Overrides of ``MXNET_GENERATION_PREFIX_CACHE`` /
        ``_PREFIX_MIN_TOKENS``: cache prompt-prefix KV in free slab slots
        and admit matching prompts by fork + suffix prefill.
    spec_k : int, optional
        Override of ``MXNET_GENERATION_SPEC_K``: the draft length of the
        speculative lane (0 = plain one-token decode). The slab grows
        `spec_k` scratch rows so that a near-capacity slot's verify writes
        stay in range, which costs `spec_k` positions of the model's range.
    draft : speculative.Draft, optional
        The speculative lane's draft (default: a `CheckpointDraft` from
        ``MXNET_GENERATION_DRAFT``, else the `NgramDraft`).

    The QoS registry (`qos.active`) is read once, here: with one active
    the slab holds ``max_slots + MXNET_QOS_PARK_SLOTS`` rows
    (`total_slots`), and every slab-shaped program covers them all.
    """

    def __init__(self, model, params=None, max_slots=None, max_len=None,
                 buckets=None, max_queue=None, tick_budget_ms=None,
                 eos_id=None, start=True, prefix_cache=None,
                 prefix_min_tokens=None, spec_k=None, draft=None):
        self._model = model
        self._shared = _model_state(model)
        with self._shared["lock"]:
            if params is None:
                ws0 = _bound_set(self._shared)
                if ws0 is None:
                    ws0 = _ParamSet()
                    self._shared["bound"] = weakref.ref(ws0)
            else:
                ws0 = _ParamSet(state_like(model, params, "GenerationEngine"))
                self._bind_set(ws0)
                ws0.tensors = None      # the parameters hold it now
        self._slots = int(getenv("MXNET_GENERATION_SLOTS")
                          if max_slots is None else max_slots)
        if self._slots < 1:
            raise MXNetError(f"need >= 1 slot, got {self._slots}")
        self._spec_k = int(getenv("MXNET_GENERATION_SPEC_K")
                           if spec_k is None else spec_k)
        if self._spec_k < 0:
            raise MXNetError(f"spec_k must be >= 0, got {self._spec_k}")
        self._max_len = min(int(getenv("MXNET_GENERATION_MAX_LEN")
                                if max_len is None else max_len),
                            model.cfg.max_len - self._spec_k)
        if self._max_len < 2:
            raise MXNetError(
                f"max_len {self._max_len} after reserving {self._spec_k} "
                f"speculative scratch rows from the model's positional "
                f"range {model.cfg.max_len}: lower MXNET_GENERATION_SPEC_K")
        # spec_k scratch rows past session capacity: a verify block that
        # starts at the last legal position writes k rows past it
        self._slab_len = self._max_len + self._spec_k
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
        # multi-tenant QoS (off unless a registry is active): the park
        # region's rows follow the session slots; with QoS off
        # _total_slots == _slots and every program is the lane-free one
        self._qos = qos.active()
        self._park = (int(getenv("MXNET_QOS_PARK_SLOTS"))
                      if self._qos is not None else 0)
        if self._park < 0:
            raise MXNetError(
                f"MXNET_QOS_PARK_SLOTS must be >= 0, got {self._park}")
        self._total_slots = self._slots + self._park
        self._parked = {}     # park row -> {sess, length, last_tok, parked_at}
        self._park_free = list(range(self._slots, self._total_slots))
        self._admit_seq = 0
        # the graphs keep the slab's pointers: it is never reallocated
        self._ck, self._cv = model.init_cache(self._total_slots,
                                              self._slab_len)
        # host-side slot metadata, mutated only under _tick_lock
        self._sessions = [None] * self._total_slots
        self._lengths = np.zeros(self._total_slots, np.int32)
        self._last_tok = np.zeros(self._total_slots, np.int32)
        self._live = 0
        # the overlap order's token copies: one pinned buffer a version
        # cohort, reused once the last commit has read it
        self._tok_pins = []

        self._queue = AdmissionQueue(max_queue,
                                     metric_prefix="serving.generation")
        # the kv_cache category of the memory census: the slab, a live view
        memory.register_provider("kv_cache", self,
                                 lambda e: [e._ck, e._cv])
        self._tokens_window = 0
        self._rate_t0 = time.monotonic()
        self._tick_lock = threading.Lock()
        self._work = threading.Condition()
        self._waiting = 0     # callers queued for the tick lock (_exclusive)
        self._closed = False
        self._warmed = False
        self.sessions_submitted = 0
        # the lanes' counts (the JAX package's prefix.* / spec.* counters)
        self.prefix_hits = self.prefix_misses = 0
        self.spec_committed = self.spec_verified_slots = 0

        # weight rollout: {version: (its _ParamSet, the WeightSet that
        # published it or None)} for every version a live session may
        # still decode under; version 0 is the set the engine was built on
        self._weights_version = 0
        self._param_sets = {0: (ws0, None)}

        self.health_name, self._beacon = attach_engine(self)
        if self._qos is not None and health._enabled:
            # per-tenant TTFT burn rows, once a registry
            qos.attach_slo(self._qos)
        use_prefix = (bool(getenv("MXNET_GENERATION_PREFIX_CACHE"))
                      if prefix_cache is None else bool(prefix_cache))
        self._prefix_min = int(
            getenv("MXNET_GENERATION_PREFIX_MIN_TOKENS")
            if prefix_min_tokens is None else prefix_min_tokens)
        self._prefix = (RadixPrefixCache(owner=self.health_name)
                        if use_prefix else None)
        self._draft = None
        if self._spec_k:
            self._draft = (speculative.default_draft(model.device)
                           if draft is None else draft)
            self._draft.attach(self)

        self._worker = None
        if start:
            self._worker = threading.Thread(
                target=self._loop, daemon=True,
                name="mxnet_tpu_torch.serving.generation.engine")
            self._worker.start()

    # -- properties ----------------------------------------------------------

    @property
    def max_slots(self):
        """Session capacity (the park rows are preemption room, never
        admitted into)."""
        return self._slots

    @property
    def total_slots(self):
        """Slab rows including the QoS park region: the slot dimension of
        every slab-shaped program and of a checkpoint draft's slab."""
        return self._total_slots

    @property
    def parked_count(self):
        """Preempted sessions parked in the slab's park region now."""
        return len(self._parked)

    @property
    def batch_live(self):
        """Live batch-class sessions: the router's class-placement
        signal. Always 0 while QoS is off."""
        if self._qos is None:
            return 0
        return sum(1 for s in self._sessions
                   if s is not None and s.qos_rank == qos.BATCH_RANK)

    @property
    def device(self):
        return self._model.device

    @property
    def max_len(self):
        return self._max_len

    @property
    def prefill_buckets(self):
        return self._buckets

    @property
    def spec_k(self):
        """Draft length of the speculative lane (0 = plain decode)."""
        return self._spec_k

    @property
    def draft(self):
        return self._draft

    @property
    def prefix_cache(self):
        """The engine's `RadixPrefixCache` (None when disabled)."""
        return self._prefix

    @property
    def weights_version(self):
        """Version of the CURRENT weight set (new admissions use it; live
        sessions keep the version they were admitted under)."""
        return self._weights_version

    @property
    def live_weight_versions(self):
        """Sorted versions some live session still decodes under, plus
        the current one: more than one only while an old version drains
        after a swap."""
        versions = {s.version for s in self._sessions if s is not None}
        versions.add(self._weights_version)
        return sorted(versions)

    def prefix_match_len(self, prompt):
        """Longest USABLE cached prefix of ``prompt`` on this engine (0
        below the fork threshold or with the cache off): the router's
        affinity probe, a host trie walk. Only current-version entries
        count, as for admission."""
        if self._prefix is None:
            return 0
        m = self._prefix.match_len(
            np.asarray(prompt, dtype=np.int32).reshape(-1),
            version=self._weights_version)
        return m if m >= self._prefix_min else 0

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
    def load(self):
        """Occupancy the router balances on: (live + queued) / slots."""
        return (self._live + len(self._queue)) / float(self._slots)

    @property
    def closed(self):
        return self._closed

    # -- health --------------------------------------------------------------

    def healthy(self):
        """Liveness: (ok, detail). False only when the scheduler worker
        died while the engine still owes work (a closed engine's joined
        worker is fine, and an engine ticked by hand has none)."""
        if (self._worker is not None and not self._worker.is_alive()
                and not self._closed):
            return False, "scheduler worker thread died"
        return True, "ok"

    def ready(self):
        """Readiness: (ok, reason), the router's placement gate. Not ready
        while draining (closed), while the watchdog marks the tick beacon
        stalled, before any program exists (`warm` not run and no traffic
        built one), or with the intake queue above its watermark."""
        if self._closed:
            return False, "closed (draining)"
        if self._beacon.stalled:
            return False, "scheduler stalled (watchdog)"
        if not self._warmed and not len(self._cache):
            return False, "warmup not run"
        return queue_ready(self._queue)

    def kv_slab_bytes(self):
        """Device bytes the KV slab pins, keys and values."""
        return int(self._ck.nbytes) + int(self._cv.nbytes)

    def bucket_for(self, n):
        for b in self._buckets:
            if b >= n:
                return b
        return None

    # -- client API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens=64, eos_id=None, timeout=None,
               tenant=None):
        """Admit one prompt; returns a `GenerationStream` at once.
        `timeout` (seconds) is the SESSION deadline, checked every tick in
        the queue, mid-generation and while parked; expiry evicts the slot
        and fails the stream with `DeadlineExceededError`. `tenant` names
        the QoS tenant (its class, quotas and weight; ignored while QoS is
        off). Raises `QueueFullError`, `ServerClosedError` and, QoS on,
        `qos.QuotaExceededError` synchronously, and MXNetError on a prompt
        that is empty, holds a token outside the vocabulary (an index the
        card cannot clamp), or does not fit a bucket or the slab."""
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
                                  deadline, tenant=tenant)
        sess = _Session(prompt, max_new_tokens,
                        self._eos_id if eos_id is None else eos_id,
                        deadline, stream, tenant=tenant)
        if tracing._enabled:
            sess.span = tracing.begin("generation.session", cat="generation",
                                      prompt_tokens=int(prompt.size),
                                      max_new_tokens=int(max_new_tokens))
        try:
            self._queue.put(Request([prompt], 1, stream._future,
                                    deadline=deadline, payload=sess,
                                    tenant=tenant))
        except Exception as e:
            if sess.span is not None:
                sess.span.set(error=repr(e)).finish()
            raise
        if telemetry._enabled:
            telemetry.counter("serving.generation.sessions").inc()
        if health._enabled:
            # work is pending: the tick beacon's silence now counts
            self._beacon.arm()
        with self._work:
            self.sessions_submitted += 1
            self._work.notify_all()
        return stream

    def generate(self, prompt, **kwargs):
        """Blocking convenience: submit and collect the full token list."""
        return list(self.submit(prompt, **kwargs))

    def warm(self, buckets=None):
        """Build every program the enabled lanes will run, counted
        exactly: one prefill per bucket, plus (prefix cache on) one suffix
        prefill per bucket, plus THE fork program (prefix cache on, or a
        QoS park region: preemption and resume ride it), plus THE decode
        program (plain) or THE verify program and the draft's own programs
        (speculative); on the card each build is one capture. The prefill
        warms write garbage into a FREE slot (skipped, with a log, when
        the slab is full); the decode or verify warm runs only while no
        session is live and writes to the safe rows (`_tick_positions`),
        so warming never perturbs a session or a cached prefix. Returns
        ``{"buckets", "compiles", "captures", "seconds",
        "cache_entries"}``."""
        buckets = (self._buckets if buckets is None
                   else tuple(sorted({int(b) for b in buckets})))
        t0 = time.perf_counter()
        with self._exclusive(), self._shared["lock"]:
            self._bind_version(self._weights_version)
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
                if self._prefix is not None:
                    self._suffix_prefill_fn(b)(np.zeros(b, np.int64), 1,
                                               free, 0)
            if (self._prefix is not None or self._park) and free is not None:
                self._fork_fn()(free, free)   # a self-copy disturbs nothing
            idle = self._live == 0
            if self._spec_k:
                if idle:
                    self._verify_fn()(
                        np.zeros((self._total_slots, self._spec_k + 1),
                                 np.int64),
                        self._tick_positions())
                    self._draft.warm()
                else:
                    _logger.warning("generation warmup: engine busy, "
                                    "skipping verify and draft warm")
            elif idle:
                self._decode_fn()(self._last_tok, self._tick_positions())
            compiles = self._cache.misses - misses0
            captures = self.captures - captures0
        self._warmed = True
        if telemetry._enabled:
            telemetry.counter("serving.generation.warmup_compiles").inc(
                compiles)
        return {"buckets": list(buckets), "compiles": compiles,
                "captures": captures,
                "seconds": time.perf_counter() - t0,
                "cache_entries": len(self._cache)}

    # -- weight rollout ------------------------------------------------------

    def _bind_set(self, ws):
        """Make the model's parameters hold `ws` (the model's lock held),
        unless they hold it already. The displaced set keeps a copy first
        when the parameters were its only one and some engine still holds
        it."""
        bound = _bound_set(self._shared)
        if bound is ws:
            return
        params = dict(self._model.named_parameters())
        with torch.no_grad():
            if bound is not None and bound.tensors is None:
                bound.tensors = {n: p.detach().clone()
                                 for n, p in params.items()}
            for name, p in params.items():
                p.copy_(ws.tensors[name])
        self._shared["bound"] = weakref.ref(ws)

    def _bind_version(self, version):
        """Write `version`'s set into the model's parameters (the tick
        lock and the model's lock held), unless they hold it already."""
        self._bind_set(self._param_sets[version][0])

    def swap_weights(self, weights, draft_params=None, version=None):
        """Flip to new weights BETWEEN ticks (takes the tick lock): new
        admissions prefill and decode under them; sessions already live
        keep decoding, bit-exact, under the version they were admitted
        with until they finish (the tick replays the decode or verify
        program once per live version, other cohorts' positions steered
        to the safe rows). The slab, the prefix cache's structure and the
        draft's slab survive; prefix entries of other versions are
        evicted (their K/V would splice old-weight rows under new-weight
        logits), and a checkpoint draft's parameters flip at once
        (stale draft rows only cost acceptance; the verify decides).

        ``weights`` is a `rollout.WeightSet` or a plain dict of arrays or
        tensors. Returns the new version, or None when ``version`` is the
        current one (an idempotent double publish). Rolling back to a
        version still pinned by draining sessions reuses its copy. Raises
        MXNetError, changing nothing, on other names or shapes. Another
        engine over the same model keeps serving its own set."""
        ws = None
        if hasattr(weights, "arg_params") and hasattr(weights, "version"):
            ws = weights
            version = ws.version if version is None else version
            new = dict(ws.arg_params)
            new.update(ws.aux_params)
            if draft_params is None and ws.draft_params:
                draft_params = ws.draft_params
        else:
            new = dict(weights)
        placed = None
        if version is None or (int(version) != self._weights_version
                               and int(version) not in self._param_sets):
            # the same names and shapes, cast to the bound dtypes and put
            # on the card BEFORE the tick lock: a host set's copy to the
            # card would stall every tick behind it. The swap under the
            # lock is then a copy into the tensors every graph reads (the
            # outgoing set keeps a copy when it is displaced)
            placed = state_like(self._model, new, "swap_weights")
        with self._exclusive(), self._shared["lock"]:
            if version is None:
                version = self._weights_version + 1
            version = int(version)
            if version == self._weights_version:
                return None
            held = self._param_sets.get(version)
            if held is None:
                if placed is None:   # pinned or current when first read
                    placed = state_like(self._model, new, "swap_weights")
                self._param_sets[version] = (
                    _ParamSet(placed),
                    ws.acquire() if ws is not None else None)
            self._weights_version = version
            self._bind_version(version)
            if draft_params and self._draft is not None:
                self._draft.swap_params(draft_params)
            if self._prefix is not None:
                self._prefix.evict_other_versions(version)
            self._gc_param_sets()
        if telemetry._enabled:
            telemetry.counter("serving.generation.weight_swaps").inc()
            telemetry.gauge("serving.generation.weights_version").set(
                version)
        if health._enabled:
            health.event("rollout_swap", engine=self.health_name,
                         version=version,
                         draining=len(self._param_sets) - 1)
        _logger.info("weights swapped to version %d (%d older version(s) "
                     "still draining)", version, len(self._param_sets) - 1)
        return version

    def weights_snapshot(self):
        """Host copies of the CURRENT weights (and a checkpoint draft's)
        in the port's names, bf16 as float32, with their version:
        ``(version, params, draft or None)``."""
        with self._exclusive(), self._shared["lock"]:
            self._bind_version(self._weights_version)
            params = {k: _host_copy(v)
                      for k, v in self._model.named_parameters()}
            draft = None
            if hasattr(self._draft, "model"):
                draft = {k: _host_copy(v)
                         for k, v in self._draft.model.named_parameters()}
            return self._weights_version, params, draft

    def _cohorts(self):
        """Live slots grouped by pinned weights version: one group in
        steady state, more only while old versions drain after swaps."""
        out = {}
        for slot, sess in enumerate(self._sessions):
            if sess is not None:
                out.setdefault(sess.version, []).append(slot)
        return out

    def _gc_param_sets(self):
        """Release weight versions no live session pins (tick lock held).
        The current version always stays; a released WeightSet drops this
        engine's reference, and the drain is journaled."""
        if len(self._param_sets) <= 1:
            return
        pinned = {s.version for s in self._sessions if s is not None}
        pinned.add(self._weights_version)
        for v in [v for v in self._param_sets if v not in pinned]:
            _, ws = self._param_sets.pop(v)
            if ws is not None:
                ws.release()
            if health._enabled:
                health.event("rollout_drained", engine=self.health_name,
                             version=v, current=self._weights_version)

    def close(self, timeout=None):
        """Graceful drain: stop admission (`ServerClosedError` for new
        submits), keep ticking until every admitted AND queued session
        completes, join the worker. Idempotent. Deregisters the health
        probes and drops every WeightSet reference."""
        self._queue.close()
        self._closed = True
        with self._work:
            self._work.notify_all()
        if self._worker is not None and self._worker.is_alive():
            self._worker.join(timeout)
        health.unregister(self.health_name)
        with self._exclusive():
            for _, ws in self._param_sets.values():
                if ws is not None:
                    ws.release()
            self._param_sets = {
                self._weights_version:
                    (self._param_sets[self._weights_version][0], None)}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def stats(self):
        out = {"cache": self._cache.snapshot(), "captures": self.captures,
               "buckets": list(self._buckets), "slots": self._slots,
               "live": self._live, "queued": len(self._queue),
               "sessions": self.sessions_submitted,
               "max_len": self._max_len, "spec_k": self._spec_k,
               "kv_slab_bytes": self.kv_slab_bytes(),
               "weights_version": self._weights_version,
               "weight_versions_live": self.live_weight_versions,
               "prefix_hits": self.prefix_hits,
               "prefix_misses": self.prefix_misses,
               "spec_committed": self.spec_committed,
               "spec_verified_slots": self.spec_verified_slots}
        if self._prefix is not None:
            out["prefix"] = self._prefix.stats()
        if hasattr(self._draft, "slab_bytes"):
            out["draft_slab_bytes"] = self._draft.slab_bytes()
        if self._qos is not None:
            out["qos"] = {"park_slots": self._park,
                          "parked": len(self._parked),
                          "weighted_demand": self.qos_demand()}
        return out

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
                                self._pool, reads=self._reads)

        return self._cache.get_or_build(
            ("prefill", bucket, self._total_slots, self._slab_len), build)

    def _reads(self):
        """What the programs read besides their inputs: the parameters and
        the slab (the observatory's bytes of an entry)."""
        return [*self._model.parameters(), self._ck, self._cv]

    def _tick_key(self):
        """The cache key of the program a tick's decode runs."""
        return (("verify", self._spec_k, self._total_slots, self._slab_len)
                if self._spec_k else
                ("decode", self._total_slots, self._slab_len))

    def _decode_fn(self):
        """THE decode program: one step over the whole slab, (tokens,
        positions) -> the greedy token of every slot. Its key never
        changes, so admission and eviction only ever hit it."""
        model, ck, cv = self._model, self._ck, self._cv

        def fn(tokens, positions):
            logits, _, _ = model.decode_step(ck, cv, tokens, positions)
            return logits.argmax(-1), logits

        def build():
            return GraphProgram(fn, [(self._total_slots,),
                                     (self._total_slots,)],
                                model.device, self._pool, reads=self._reads)

        return self._cache.get_or_build(
            ("decode", self._total_slots, self._slab_len), build)

    def _fork_fn(self):
        """THE fork program: (src, dst) -> copy slot `src`'s slab rows,
        K and V, every layer, onto slot `dst`. One program serves every
        (cached entry, session slot) pair, and the park region's preempt
        (slot -> park row) and resume (park row -> slot) copies."""
        model, ck, cv = self._model, self._ck, self._cv

        def fn(src, dst):
            ck.index_copy_(0, dst, ck.index_select(0, src))
            cv.index_copy_(0, dst, cv.index_select(0, src))
            return (dst,)

        def build():
            return GraphProgram(fn, [(1,), (1,)], model.device, self._pool)

        return self._cache.get_or_build(
            ("fork", self._total_slots, self._slab_len), build)

    def _suffix_prefill_fn(self, bucket):
        """The bucket's suffix-prefill program: (padded suffix, length,
        slot, offset) -> the greedy next token, writing the slot's rows
        ``[offset, offset + bucket)`` and attending the forked prefix."""
        model, ck, cv = self._model, self._ck, self._cv

        def fn(tokens, length, slot, offset):
            logits, _, _ = model.prefill_at(ck, cv, tokens, length, slot,
                                            offset)
            return logits.argmax().reshape(1), logits

        def build():
            return GraphProgram(fn, [(bucket,), (1,), (1,), (1,)],
                                model.device, self._pool, reads=self._reads)

        return self._cache.get_or_build(
            ("suffix_prefill", bucket, self._total_slots, self._slab_len),
            build)

    def _verify_fn(self):
        """THE verify program: k + 1 unrolled decode steps over the whole
        slab, (tokens [S, k+1], positions) -> the greedy token after each
        prefix of every slot's block. Its key never changes."""
        model, ck, cv = self._model, self._ck, self._cv
        k1 = self._spec_k + 1

        def fn(tokens, positions):
            logits, _, _ = model.verify_step(ck, cv, tokens, positions)
            return logits.argmax(-1), logits

        def build():
            return GraphProgram(fn, [(self._total_slots, k1),
                                     (self._total_slots,)],
                                model.device, self._pool, reads=self._reads)

        return self._cache.get_or_build(
            ("verify", self._spec_k, self._total_slots, self._slab_len),
            build)

    # -- scheduler -----------------------------------------------------------

    def _has_work(self):
        return (self._live > 0 or len(self._queue) > 0
                or len(self._parked) > 0)

    @contextlib.contextmanager
    def _exclusive(self):
        """The tick lock for a caller outside the scheduler (`warm`,
        `swap_weights`, `weights_snapshot`, `close`): while one waits, the
        worker and assisting iterators leave the lock to it between ticks.
        A plain wait could starve: the worker retakes the lock at once
        after each tick."""
        with self._work:
            self._waiting += 1
        try:
            with self._tick_lock:
                yield
        finally:
            with self._work:
                self._waiting -= 1
                self._work.notify_all()

    def _loop(self):
        while True:
            with self._work:
                while not self._closed and (self._waiting
                                            or not self._has_work()):
                    self._work.wait()
                if self._closed and not self._has_work():
                    return
            self._tick_once()

    def _assist_once(self):
        """Caller-runs assist (stream iterators call this while waiting):
        run one tick inline if the tick lock is free. Returns True when a
        tick ran (or there was nothing to do), False when another thread
        holds the lock or an `_exclusive` caller waits for it."""
        if self._waiting or not self._tick_lock.acquire(blocking=False):
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
        """One scheduler tick (tick lock held). Lockstep order: sweep
        deadlines (queue, slots, park region), admit prefills into free
        slots (preempting for a higher class first), run ONE decode over
        the slab and commit its tokens. Overlap order
        (``MXNET_OVERLAP``): launch the decode first, do the sweeps and
        the admission while it runs, then wait for its tokens and commit.
        A tick never raises: a failure fails the live and parked sessions
        in band and zeroes the slab in place, so the captured graphs stay
        valid and no session reads rows a failed program half wrote. The
        model's lock is held throughout, with this engine's weights bound
        (engines sharing the model tick one at a time)."""
        with self._shared["lock"]:
            self._tick_locked()

    def _tick_locked(self):
        tele = telemetry._enabled
        obs = observatory._enabled
        decoded = False
        events = None
        t0 = time.perf_counter()
        tick_span = tracing.span("generation.tick", cat="generation",
                                 live=self._live, queued=len(self._queue))
        with tick_span:
            try:
                self._bind_version(self._weights_version)
                overlap = _staging.overlap_enabled()
                if not overlap:
                    self._sweep_and_admit()
                decoded = self._live > 0
                if obs and decoded and self._ck.is_cuda:
                    # device time of the decode, read in the observatory's
                    # summary, never here
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                with tracing.span("generation.decode", cat="generation",
                                  live=self._live):
                    pending = self._decode_dispatch(overlap)
                if events is not None:
                    events[1].record()
                if overlap:
                    # the host work of the tick, while the card decodes;
                    # admitted prefills queue behind the decode on the
                    # stream and join the NEXT tick's decode
                    self._sweep_and_admit()
                if pending is not None:
                    self._decode_commit(pending)
                if len(self._param_sets) > 1:
                    # a swap is draining: release versions whose last
                    # session just finished
                    self._gc_param_sets()
            except Exception as e:  # noqa: BLE001 - never strand a session
                _logger.exception("generation tick failed")
                tick_span.set(error=repr(e))
                events = None
                for slot, sess in enumerate(self._sessions):
                    if sess is not None:
                        self._evict(slot, "error", e)
                # parked rows lived in the same slab
                for park, rec in list(self._parked.items()):
                    self._fail_parked(park, rec, e)
                self._ck.zero_()
                self._cv.zero_()
                if self._prefix is not None:
                    self._prefix.clear("slab_reset")   # its rows were zeroed
                if self._draft is not None:
                    self._draft.reset()
                self._gc_param_sets()
                self._bind_version(self._weights_version)
        if tracing._enabled:
            tracing.tick_recorder.observe(tick_span.tree())
        if health._enabled:
            # progress: the tick ran (a failed one too); an empty slab
            # parks the scheduler, so silence while idle is no stall
            self._beacon.touch()
            if not self._has_work():
                self._beacon.idle()
        if obs and decoded:
            observatory.observe("generation.tick", self._cache,
                                self._tick_key(),
                                wall_s=time.perf_counter() - t0,
                                events=events)
        if tele:
            self._tick_telemetry(time.perf_counter() - t0)
        if self._has_work():
            # an assist tick pops the queue before the session is live; a
            # worker that re-checked _has_work() in that window went back
            # to sleep, so any tick that leaves work pending wakes it
            with self._work:
                self._work.notify_all()

    def _sweep_and_admit(self):
        """The tick's host work: fail expired queued requests, evict live
        sessions past their deadlines, sweep the park region, admit."""
        now = time.monotonic()
        for req in self._queue.expire(now):
            self._fail_queued(req.payload, now)
        for slot, sess in enumerate(self._sessions):
            if (sess is not None and sess.deadline is not None
                    and now >= sess.deadline):
                self._evict(slot, "deadline", DeadlineExceededError(
                    f"session deadline passed after "
                    f"{sess.generated} generated token(s)"))
        self._sweep_parked(now)
        with tracing.span("generation.admit", cat="generation"):
            self._admit()

    def _tick_telemetry(self, dt):
        telemetry.counter("serving.generation.ticks").inc()
        telemetry.histogram("serving.generation.tick_us").record(dt * 1e6)
        telemetry.gauge("serving.generation.live_slots").set(self._live)
        now = time.monotonic()
        if not self._has_work():
            # going idle: the parked scheduler never recomputes the rate
            telemetry.gauge("serving.generation.tokens_per_s").set(0.0)
            self._tokens_window = 0
            self._rate_t0 = now
        elif now - self._rate_t0 >= 0.5:
            telemetry.gauge("serving.generation.tokens_per_s").set(
                self._tokens_window / (now - self._rate_t0))
            self._tokens_window = 0
            self._rate_t0 = now

    def _free_slots(self):
        """Slots holding neither a live session nor a cached prefix."""
        held = self._prefix.slots() if self._prefix is not None else ()
        return [i for i in range(self._slots)
                if self._sessions[i] is None and i not in held]

    def _tick_positions(self, active=None):
        """Write positions for the decode and verify programs: a live
        slot's length, and the safe row ``max_len - 1`` for every other
        slot. Dead and cache-held slots still get K/V rows written every
        tick (the fixed shape computes all slots), rows ``[safe, safe +
        spec_k]``: the slab's last ``spec_k + 1`` rows, which no cached
        entry owns (a cached prompt has at most ``max_len - 1`` tokens)
        and which a live session writes before it reads them.

        ``active`` (slot indices) also steers every LIVE slot outside it
        to the safe row: the per-version cohort replay during a weight
        swap, where each replay must advance only its own slots. Every
        write must be in range, since the card faults where JAX clamps:
        checked here."""
        pos = self._lengths.copy()
        safe = self._max_len - 1
        act = None if active is None else set(active)
        for i, s in enumerate(self._sessions):
            if s is None or (act is not None and i not in act):
                pos[i] = safe
        if pos.min() < 0 or pos.max() > safe:
            raise MXNetError(f"decode positions {pos} outside the rows "
                             f"[0, {safe}] of a slab of {self._slab_len}")
        return pos

    def _prefix_claimable(self):
        """Cache entries session pressure may evict: all above the
        retention floor (one entry, none on a one-slot engine), which
        keeps the hottest prefix through full occupancy."""
        if self._prefix is None:
            return 0
        keep = min(1, max(self._slots - 1, 0))
        return max(len(self._prefix) - keep, 0)

    def _claim_slot(self, free):
        """Pop a slot for a session: from the free list, else by evicting
        the LRU unpinned prefix entry above the retention floor (live
        sessions outrank cached prefixes). None when the slab is full."""
        if free:
            return free.pop(0)
        if not (self._prefix_claimable() and len(self._queue)):
            return None
        # the entry the queue's head would fork from stays pinned while
        # the victim is picked: evicting it to seat that very session
        # would turn its hit into a miss
        head = self._queue.peek()
        node = None
        if head is not None:
            node, m = self._prefix.match(head.payload.prompt,
                                         version=self._weights_version)
            if m < self._prefix_min:
                node = None
        if node is None:
            return self._prefix.evict_lru("slot_pressure")
        self._prefix.acquire(node)
        try:
            return self._prefix.evict_lru("slot_pressure")
        finally:
            self._prefix.release(node)

    def _admit(self):
        """Move queued sessions into free slots (prefill), oldest first
        (QoS on: class and deadline order), until the slab is full, the
        queue is empty or the tick budget is spent: at least one admission
        per tick when a slot is free or freeable by evicting a cached
        prefix. With QoS on, a full slab with a higher-class request at
        the queue's head first parks the youngest batch session (one a
        tick)."""
        free = self._free_slots()
        if self._qos is not None and not free:
            freed = self._preempt_for_priority()
            if freed is not None:
                free = [freed]
        if free or (self._prefix_claimable() and len(self._queue)):
            self._admit_into(free, time.perf_counter())

    def _admit_into(self, free, t0):
        while True:
            slot = self._claim_slot(free)
            if slot is None:
                return
            if (self._qos is not None and self._parked
                    and self._should_resume()):
                # no queued request outranks the parked batch work: the
                # oldest parked session takes this slot back
                self._resume_into(slot)
                if time.perf_counter() - t0 > self._tick_budget_s:
                    return
                continue
            batch, _ = self._queue.get_batch_nowait(1)
            if not batch:
                free.append(slot)
                return
            sess = batch[0].payload
            sess.qos_rank = batch[0].qos_rank
            now = time.monotonic()
            if sess.deadline is not None and now >= sess.deadline:
                self._fail_queued(sess, now)
                free.append(slot)
                continue
            n = int(sess.prompt.size)
            trc = tracing._enabled and sess.span is not None
            if trc:
                tracing.emit_span("generation.queued", sess.span.t0,
                                  tracing.now_us() - sess.span.t0,
                                  cat="generation", parent=sess.span)
                t_pf_us = tracing.now_us()
            t_pf = time.perf_counter()
            # prefix-cache lane: fork the longest usable cached prefix,
            # then prefill only the unmatched suffix
            node = None
            if self._prefix is not None:
                node, m = self._prefix.match(sess.prompt,
                                             version=self._weights_version)
                if node is None or m < self._prefix_min:
                    node = None
                elif m + self.bucket_for(n - m) > self._slab_len:
                    # the suffix's BUCKET must fit past the split point:
                    # its rows would overhang the slab (a fault on the
                    # card). Near-capacity prompts take the full prefill
                    node = None
            try:
                if node is not None:
                    tok = self._fork_admit(sess, slot, node, m)
                else:
                    bucket = self.bucket_for(n)
                    # submit() keeps these in range; the card would fault
                    if not (bucket is not None and bucket <= self._slab_len
                            and 0 <= slot < self._slots):
                        raise MXNetError(f"prompt of {n} tokens in bucket "
                                         f"{bucket} at slot {slot} does not "
                                         f"fit the slab")
                    padded = np.zeros(bucket, np.int64)
                    padded[:n] = sess.prompt
                    tok = int(self._prefill_fn(bucket)(padded, n, slot)[0])
                    if self._prefix is not None:
                        self.prefix_misses += 1
                        if telemetry._enabled:
                            telemetry.counter(
                                "serving.generation.prefix.misses").inc()
            except Exception as e:
                # the popped session is in neither the queue nor a slot:
                # fail its stream here, or it is stranded; re-raise so the
                # tick resets the slab
                if sess.span is not None:
                    sess.span.set(error=repr(e)).finish()
                sess.stream._fail(e)
                raise
            if trc:
                tracing.emit_span("generation.prefill", t_pf_us,
                                  tracing.now_us() - t_pf_us,
                                  cat="generation", parent=sess.span,
                                  slot=slot, forked=node is not None)
            sess.slot = slot
            # pinned for the session's whole life: after a swap the tick
            # keeps decoding it under these weights
            sess.version = sess.stream.weights_version = self._weights_version
            self._admit_seq += 1
            sess.admit_seq = self._admit_seq
            self._sessions[slot] = sess
            self._lengths[slot] = n
            self._last_tok[slot] = tok
            self._live += 1
            if self._draft is not None:
                self._draft.on_admit(slot, sess.prompt, tok)
            self._deliver(sess, tok, first=True)
            if telemetry._enabled:
                telemetry.counter("serving.generation.prefills").inc()
                telemetry.histogram("serving.generation.prefill_us").record(
                    (time.perf_counter() - t_pf) * 1e6)
            # cache the prompt's K/V while a free slot exists (an insert
            # never evicts): the slot's rows [0, n) are exactly that K/V
            # right after its prefill, so one fork snapshots them
            if self._prefix is not None and n >= self._prefix_min and free:
                cslot = free[0]
                if self._prefix.insert(sess.prompt, cslot,
                                       version=sess.version) is not None:
                    free.pop(0)
                    self._fork_fn().launch(slot, cslot)
            # the first token may already end the session; its slot goes
            # straight back on the free list
            self._maybe_finish(slot)
            if self._sessions[slot] is None:
                free.append(slot)
            if time.perf_counter() - t0 > self._tick_budget_s:
                return

    def _fork_admit(self, sess, slot, node, m):
        """Cache-hit admission: pin the entry, fork its slot onto the
        session's, suffix-prefill the unmatched tail at offset ``m``.
        Returns the first sampled token."""
        suffix = sess.prompt[m:]
        ns = int(suffix.size)
        bucket = self.bucket_for(ns)
        padded = np.zeros(bucket, np.int64)
        padded[:ns] = suffix
        self._prefix.acquire(node)
        try:
            self._fork_fn().launch(node.slot, slot)
            tok = int(self._suffix_prefill_fn(bucket)(padded, ns, slot,
                                                      m)[0])
        finally:
            self._prefix.release(node)
        sess.prefix_len = m
        sess.stream.cached_prefix_len = m
        self.prefix_hits += 1
        if telemetry._enabled:
            telemetry.counter("serving.generation.prefix.hits").inc()
            telemetry.counter("serving.generation.prefix.forks").inc()
            telemetry.counter(
                "serving.generation.prefix.cached_tokens_served").inc(m)
        return tok

    def _token_pin(self, i, like):
        """The i-th pinned host buffer for a cohort's tokens."""
        while len(self._tok_pins) <= i:
            self._tok_pins.append(torch.empty(
                like.shape, dtype=like.dtype).pin_memory())
        return self._tok_pins[i]

    def _cohort_dispatch(self, prog, tokens, overlap):
        """Launch ``prog(tokens, positions)`` once per live weights
        version, that version's weights bound and the other cohorts' slots
        steered to the safe row, the current weights bound again after.
        Lockstep: each cohort's tokens are read at once. Overlap: each
        cohort's tokens are copied behind its replay into a pinned buffer
        and one event is recorded after the last; the commit waits on it.
        Returns ``([(slots, their sessions, tokens)], event or None)``."""
        cohorts = self._cohorts()
        mixed = len(cohorts) > 1
        pending = []
        event = None
        try:
            for n, version in enumerate(sorted(cohorts)):
                slots = cohorts[version]
                self._bind_version(version)
                pos = (self._tick_positions(slots) if mixed
                       else self._tick_positions())
                if not overlap:
                    toks = prog(tokens, pos)
                else:
                    out = prog.launch(tokens, pos)
                    if out.is_cuda:
                        toks = self._token_pin(n, out)
                        toks.copy_(out, non_blocking=True)
                    else:
                        toks = out.clone()
                # a slot evicted, preempted or re-admitted before the
                # commit fails the identity check there; its token drops
                pending.append((slots, [self._sessions[s] for s in slots],
                                toks))
        finally:
            self._bind_version(self._weights_version)
        if overlap and self._ck.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return pending, event

    def _decode_dispatch(self, overlap):
        """Launch ONE step over the whole slab, once per version cohort:
        every live session advances one token (plain) or up to ``spec_k +
        1`` (speculative verify) at the commit; dead and park rows ride
        along as masked garbage. Returns the state for `_decode_commit`,
        or None when no slot is live."""
        if self._live == 0:
            return None
        if self._spec_k:
            return self._spec_dispatch(overlap)
        return "plain", self._cohort_dispatch(self._decode_fn(),
                                              self._last_tok.copy(), overlap)

    @staticmethod
    def _tokens(pending, event):
        """Wait for the dispatched tokens (overlap: on the event) and
        return them as host arrays."""
        if event is not None:
            event.synchronize()
        return [(slots, snap, np.asarray(toks.numpy()
                                         if torch.is_tensor(toks) else toks))
                for slots, snap, toks in pending]

    def _decode_commit(self, state):
        """Deliver one token per still-live slot, advance its length and
        evict the sessions that ended."""
        kind, pending = state
        if kind == "spec":
            self._spec_commit(pending)
            return
        live = 0
        for slots, snap, toks in self._tokens(*pending):
            for slot, dispatched in zip(slots, snap):
                sess = self._sessions[slot]
                if sess is None or sess is not dispatched:
                    continue
                live += 1
                # the token we fed now occupies position lengths[slot]
                self._lengths[slot] += 1
                tok = int(toks[slot])
                self._last_tok[slot] = tok
                self._deliver(sess, tok)
                self._maybe_finish(slot)
            if telemetry._enabled:
                telemetry.counter("serving.generation.tick_slots").inc(
                    self._slots)
        if telemetry._enabled:
            telemetry.counter("serving.generation.decode_tokens").inc(live)

    def _spec_dispatch(self, overlap):
        """The draft proposes k tokens a slot, once, with its current
        parameters (proposals may be wrong for an old cohort; its verify
        corrects them), then the verify program runs per cohort."""
        k = self._spec_k
        props = np.asarray(self._draft.propose(k, self._sessions),
                           np.int64)                            # [S, k]
        tokens = np.concatenate([self._last_tok[:, None].astype(np.int64),
                                 props], axis=1)
        return "spec", (props, self._cohort_dispatch(self._verify_fn(),
                                                     tokens, overlap))

    def _spec_commit(self, state):
        """Each still-live slot takes the longest agreeing draft prefix
        plus the target's next token (1..k+1 tokens), rolling the rest
        back by NOT advancing its position: the rejected rows beyond the
        new frontier are never attended and are overwritten in order
        before they could be."""
        props, pending = state
        k = self._spec_k
        live = accepted = committed_total = 0
        for slots, snap, toks in self._tokens(*pending):
            for slot, dispatched in zip(slots, snap):
                sess = self._sessions[slot]
                if sess is None or sess is not dispatched:
                    continue
                live += 1
                t, d = toks[slot], props[slot]
                a = 0
                while a < k and d[a] == t[a]:
                    a += 1
                committed = []
                for j in range(a + 1):
                    # as one plain decode step: the token fed at position
                    # lengths[slot] is now in the slab, t[j] is the next
                    self._lengths[slot] += 1
                    tok = int(t[j])
                    self._last_tok[slot] = tok
                    committed.append(tok)
                    self._deliver(sess, tok)
                    self._maybe_finish(slot)
                    if self._sessions[slot] is None:
                        break
                if self._sessions[slot] is not None:
                    self._draft.on_commit(slot, committed)
                self.spec_verified_slots += 1
                self.spec_committed += len(committed)
                # accepted drafts: all committed tokens but the bonus one
                # (every one of them when a terminal state cut the loop)
                accepted += min(len(committed), a)
                committed_total += len(committed)
            if telemetry._enabled:
                telemetry.counter("serving.generation.tick_slots").inc(
                    self._slots)
        if telemetry._enabled:
            telemetry.counter("serving.generation.decode_tokens").inc(live)
            telemetry.counter("serving.generation.spec.ticks").inc()
            telemetry.counter("serving.generation.spec.verified_slots").inc(
                live)
            telemetry.counter("serving.generation.spec.proposed").inc(
                live * k)
            telemetry.counter("serving.generation.spec.accepted").inc(
                accepted)
            telemetry.counter("serving.generation.spec.rolled_back").inc(
                live * k - accepted)
            telemetry.counter("serving.generation.spec.committed").inc(
                committed_total)

    # -- delivery / eviction -------------------------------------------------

    def _deliver(self, sess, tok, first=False):
        sess.generated += 1
        sess.stream._push(tok)
        self._tokens_window += 1
        if self._qos is not None:
            # the token-rate quota, charged as tokens are delivered (may
            # drive the bucket negative: the tenant's NEXT admission waits)
            self._qos.charge_tokens(sess.tenant, 1)
        if telemetry._enabled:
            telemetry.counter("serving.generation.tokens").inc()
            spec = (self._qos.spec_for(sess.tenant)
                    if self._qos is not None else None)
            if spec is not None:
                telemetry.counter(
                    qos.labeled_metric("qos.tokens", spec)).inc()
            # generated == 1: an adopted session's re-prefill delivers into
            # a stream whose first token came on another replica
            if first and sess.generated == 1:
                ttft = (time.monotonic() - sess.stream.submitted_at) * 1e6
                telemetry.histogram("serving.generation.ttft_us").record(
                    ttft)
                if spec is not None:
                    telemetry.histogram(
                        qos.labeled_metric("qos.ttft_us", spec)).record(ttft)
                if sess.prefix_len:
                    telemetry.histogram(
                        "serving.generation.prefix.ttft_us").record(ttft)

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
        if self._draft is not None:
            self._draft.on_evict(slot)
        if telemetry._enabled:
            telemetry.counter("serving.generation.evictions").inc()
            telemetry.counter(f"serving.generation.evict_{reason}").inc()
        if reason not in ("eos", "finished"):
            _logger.info("generation slot %d evicted (%s) after %d token(s)",
                         slot, reason, sess.generated)
            if health._enabled:
                health.event("generation_evict", engine=self.health_name,
                             slot=slot, reason=reason,
                             tokens=sess.generated)
        if sess.span is not None:
            sess.span.set(reason=reason, tokens=sess.generated)
            if exc is not None:
                sess.span.set(error=repr(exc))
            sess.span.finish()
        if exc is not None:
            sess.stream._fail(exc)
        else:
            sess.stream._finish()

    def _fail_queued(self, sess, now):
        """Deadline death while still queued: no slot to free, only the
        stream to unblock."""
        if sess.span is not None:
            sess.span.set(error="deadline in queue").finish()
        sess.stream._fail(DeadlineExceededError(
            f"session waited {now - sess.stream.submitted_at:.3f}s in "
            "queue, past its deadline"))

    # -- QoS park region (preemption, resume, migration) ----------------------

    def _sweep_parked(self, now):
        """Deadline sweep over the park region: parking does not stop a
        session's clock."""
        for park, rec in list(self._parked.items()):
            sess = rec["sess"]
            if sess.deadline is not None and now >= sess.deadline:
                self._fail_parked(
                    park, rec, DeadlineExceededError(
                        f"session deadline passed while parked after "
                        f"{sess.generated} generated token(s)"),
                    reason="deadline")

    def _fail_parked(self, park, rec, exc, reason="error"):
        """Terminal failure of a PARKED session: free its park row and fail
        its stream in band (it is in neither the queue nor a slot)."""
        del self._parked[park]
        self._park_free.append(park)
        sess = rec["sess"]
        if telemetry._enabled:
            telemetry.counter("serving.generation.evictions").inc()
            telemetry.counter(f"serving.generation.evict_{reason}").inc()
        if health._enabled:
            health.event("generation_evict", engine=self.health_name,
                         reason=reason, parked=True, tokens=sess.generated)
        if sess.span is not None:
            sess.span.set(error=repr(exc), reason=reason,
                          parked=True).finish()
        sess.stream._fail(exc)

    def _preempt_for_priority(self):
        """Park the YOUNGEST live batch session (the fewest sunk tokens by
        admission order) when a higher-class request heads the queue and
        no slot is free: THE fork program copies its rows into a free park
        row, its host state moves aside, and its slot frees. One victim a
        call. Returns the freed slot, or None when there is no park room,
        no batch victim, or the head is itself batch (an AGED batch
        request only reorders the queue, it never preempts).

        Under the overlap order the decode in flight has already written
        the victim's next row; its token is dropped at the commit, and the
        recorded length and last token make the resumed decode compute
        that position again, so the stream stays bit-exact."""
        if not self._park_free:
            return None
        head = self._queue.peek()
        if (head is None or head.qos_rank is None
                or head.qos_rank >= qos.BATCH_RANK):
            return None
        victim = None
        for slot in range(self._slots):
            sess = self._sessions[slot]
            if sess is None or sess.qos_rank != qos.BATCH_RANK:
                continue
            if (victim is None
                    or sess.admit_seq > self._sessions[victim].admit_seq):
                victim = slot
        if victim is None:
            return None
        sess = self._sessions[victim]
        park = self._park_free.pop()
        try:
            self._fork_fn().launch(victim, park)
        except Exception:
            # the victim is still live in its slot; the tick's handler
            # fails it with the others
            self._park_free.append(park)
            raise
        self._parked[park] = {"sess": sess,
                              "length": int(self._lengths[victim]),
                              "last_tok": int(self._last_tok[victim]),
                              "parked_at": time.monotonic()}
        # paused, not dead: the stream stays open; the slot's rows become
        # masked garbage written at the safe row
        self._sessions[victim] = None
        self._lengths[victim] = 0
        self._last_tok[victim] = 0
        self._live -= 1
        if self._draft is not None:
            self._draft.on_evict(victim)
        spec = self._qos.spec_for(sess.tenant)
        if telemetry._enabled:
            telemetry.counter("serving.generation.preemptions").inc()
            telemetry.counter(qos.labeled_metric("qos.preempted", spec)).inc()
        if health._enabled:
            health.event("qos_preempt", engine=self.health_name,
                         slot=victim, park=park, tenant=spec.name,
                         tokens=sess.generated)
        if sess.span is not None:
            tracing.emit_span("generation.preempt", tracing.now_us(), 0.0,
                              cat="generation", parent=sess.span,
                              slot=victim, park=park)
        return victim

    def _should_resume(self):
        """A free slot goes back to a parked session unless a HIGHER-class
        request heads the queue (batch against batch, the parked session
        wins: it has sunk work the queued one has not)."""
        head = self._queue.peek()
        return (head is None or head.qos_rank is None
                or head.qos_rank >= qos.BATCH_RANK)

    def _resume_into(self, slot):
        """Un-park the OLDEST parked session into the free slot: THE fork
        program copies its rows back, its host state is restored, and its
        greedy decode continues bit-exact with an uninterrupted run (the
        fork is a row copy; a slot's decode does not depend on its
        index)."""
        park = min(self._parked,
                   key=lambda p: self._parked[p]["parked_at"])
        rec = self._parked.pop(park)
        sess = rec["sess"]
        try:
            self._fork_fn().launch(park, slot)
        except Exception as e:
            # the session is in neither the park region nor a slot now
            self._park_free.append(park)
            if sess.span is not None:
                sess.span.set(error=repr(e), reason="error").finish()
            sess.stream._fail(e)
            raise
        self._park_free.append(park)
        sess.slot = slot
        self._sessions[slot] = sess
        self._lengths[slot] = rec["length"]
        self._last_tok[slot] = rec["last_tok"]
        self._live += 1
        if self._draft is not None:
            # the draft's context: the prompt and every delivered token
            # but the pending last one
            ctx = np.concatenate([
                sess.prompt,
                np.asarray(sess.stream.tokens[:-1], np.int32)])
            self._draft.on_admit(slot, ctx, rec["last_tok"])
        spec = self._qos.spec_for(sess.tenant)
        if telemetry._enabled:
            telemetry.counter(qos.labeled_metric("qos.resumed", spec)).inc()
        if health._enabled:
            health.event("qos_resume", engine=self.health_name, slot=slot,
                         tenant=spec.name,
                         parked_s=round(
                             time.monotonic() - rec["parked_at"], 3))
        if sess.span is not None:
            tracing.emit_span("generation.resume", tracing.now_us(), 0.0,
                              cat="generation", parent=sess.span, slot=slot,
                              park=park)

    def qos_demand(self):
        """Fairness-weighted demand for the autoscale signal: every live
        and parked session and every queued request, each weighted by its
        tenant's QoS weight. None while QoS is off (callers then count
        ``live_slots + queue_depth``)."""
        if self._qos is None:
            return None
        d = 0.0
        for sess in self._sessions:
            if sess is not None:
                d += self._qos.weight(sess.tenant)
        for rec in self._parked.values():
            d += self._qos.weight(rec["sess"].tenant)
        return d + self._queue.weighted_depth()

    def eject_parked(self, max_n=None):
        """Take up to ``max_n`` parked sessions (oldest first) OUT of this
        engine as host records for a peer's `adopt`: prompt, tokens so
        far, budget, deadline, tenant and the LIVE stream (the client
        keeps iterating it; only its engine changes). Their park rows free
        at once. Takes the tick lock."""
        out = []
        with self._exclusive():
            parks = sorted(self._parked,
                           key=lambda p: self._parked[p]["parked_at"])
            if max_n is not None:
                parks = parks[:max_n]
            for park in parks:
                rec = self._parked.pop(park)
                self._park_free.append(park)
                sess = rec["sess"]
                out.append({"prompt": sess.prompt,
                            "tokens": list(sess.stream.tokens),
                            "max_new_tokens": sess.max_new_tokens,
                            "eos_id": sess.eos_id,
                            "deadline": sess.deadline,
                            "tenant": sess.tenant,
                            "stream": sess.stream,
                            "span": sess.span})
        if out and telemetry._enabled:
            telemetry.counter("serving.generation.qos.ejected").inc(len(out))
        return out

    def adopt(self, record):
        """Admit a session ejected from a peer: queue its FULL context
        (prompt and every token generated so far) for a prefill here and
        deliver the rest of its budget into the ORIGINAL stream. Its
        continuation equals a fresh submit of that context (it is one:
        the same prefill and greedy decode), which in bf16 need not equal
        the uninterrupted stream, since a prefill and token-by-token
        decode need not round alike. The request skips the quotas (charged
        at the first admission). Returns False when the context does not
        fit this engine or its queue refuses (the caller tries elsewhere)."""
        toks = [int(t) for t in record["tokens"]]
        ctx = np.concatenate([np.asarray(record["prompt"], np.int32).ravel(),
                              np.asarray(toks, np.int32)])
        n = int(ctx.size)
        remaining = int(record["max_new_tokens"]) - len(toks)
        if (remaining < 1 or n > self._buckets[-1]
                or n + remaining > self._max_len or self._closed):
            return False
        stream = record["stream"]
        sess = _Session(ctx, record["max_new_tokens"], record["eos_id"],
                        record["deadline"], stream, tenant=record["tenant"])
        sess.generated = len(toks)
        sess.span = record.get("span")
        req = Request([ctx], 1, stream._future, deadline=record["deadline"],
                      payload=sess, tenant=record["tenant"])
        req.qos_exempt = True
        try:
            self._queue.put(req)
        except Exception:  # noqa: BLE001 - refused: the caller keeps it
            return False
        # the stream's caller-runs assist drives THIS engine from now on
        stream._engine = self
        if telemetry._enabled:
            telemetry.counter("serving.generation.qos.adopted").inc()
        if health._enabled:
            self._beacon.arm()
        with self._work:
            self.sessions_submitted += 1
            self._work.notify_all()
        return True
