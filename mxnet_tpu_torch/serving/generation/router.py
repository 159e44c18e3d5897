"""GenerationRouter: spread sessions across engine replicas by prefix
affinity and occupancy.

The port of `mxnet_tpu/serving/generation/router.py`. One
`GenerationEngine` is one model replica with one KV slab; scale-out is N of
them behind this router. Placement is decided in two tiers:

* **prefix affinity**: each replica's `GenerationEngine.prefix_match_len`
  reports how many of the prompt's tokens its radix prefix cache could
  fork (a host trie walk, no device work); the session goes to the replica
  with the LONGEST usable match. Without this a fleet cold-misses a
  shared system prompt N - 1 times. Affinity placements are journaled
  (``router_affinity`` health events);
* **load**: with no usable match anywhere, the replica with the lowest
  ``(live slots + queued sessions) / max_slots`` wins (queued sessions
  count, so a burst does not pile onto one replica before its prefills
  land), with a rotating tie-break so an idle fleet still shares evenly.

A replica that rejects with `QueueFullError` (or `ServerClosedError`, a
replica mid-drain) fails over to the next candidate; only when EVERY
replica refuses does the caller see backpressure. With the health layer on
(``MXNET_HEALTH=1``), placement also consults each engine's readiness: an
unready replica is drained (no new sessions while its live ones finish)
and re-admitted once its probe passes, each transition journaled
(``engine_drain`` / ``engine_undrain``); a fleet with no ready replica
falls back to load order over all of them.

With a QoS registry active (`serving.qos`), class placement sits between
the two tiers: an interactive or standard session avoids replicas that
run batch work (its first token should not queue behind a flood it would
only preempt), and a batch session packs onto them. `rebalance_parked`
moves preempted sessions out of a replica's park region to a peer, which
re-prefills their whole context (`GenerationEngine.eject_parked` /
`adopt`).

`scale_to` grows the fleet from a factory (each new replica warmed before
it takes traffic, and brought onto the fleet's current weights) or drains
surplus replicas in background threads. The router registers itself as a
fleet of the health layer's autoscale signal (`health.register_fleet`),
and `bind_autoscale` wires that signal's changes (`health.on_autoscale`)
to `scale_to`. `rolling_swap` flips the fleet to new weights a replica at
a time under the scale lock, reading the SLO tracker's worst short-window
burn after each flip and rolling every flipped replica back when it
exceeds ``MXNET_ROLLOUT_SLO_GATE``. Placements count into the
``serving.generation.routed*`` series, migrations into ``qos.migrated``.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref

from ... import health, telemetry
from ...base import MXNetError, getenv
from .. import qos
from ..admission import QueueFullError, ServerClosedError

__all__ = ["GenerationRouter"]


class GenerationRouter:
    """Affinity- and occupancy-balancing front end over N generation
    engines.

    Parameters
    ----------
    engines : list[GenerationEngine]
        The initial fleet (>= 1 replica).
    factory : callable, optional
        Zero-argument constructor of one new engine, which `scale_to`
        needs to grow the fleet.
    min_engines / max_engines : int, optional
        Clamp for `scale_to` (defaults: 1 / no upper bound).
    """

    def __init__(self, engines, factory=None, min_engines=1,
                 max_engines=None):
        engines = list(engines)
        if not engines:
            raise MXNetError("GenerationRouter needs >= 1 engine")
        self._engines = engines
        self._factory = factory
        self._min = max(int(min_engines), 1)
        self._max = None if max_engines is None else int(max_engines)
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self._scale_lock = threading.Lock()
        self._ready_state = {}      # engine health_name -> last ready bool
        self._all_unready = False
        self._draining = []         # (engine, closer thread) during shrink
        self._closed = False
        # weight rollout: the fleet's current and previous WeightSets stay
        # pinned here, so rolling_swap always has a rollback target and a
        # replica grown later joins on the current version
        self._ws_current = None
        self._ws_previous = None
        health.register_fleet(self)

    @property
    def engines(self):
        with self._lock:
            return list(self._engines)

    def loads(self):
        """Per-replica occupancy, the placement signal."""
        return [e.load for e in self.engines]

    def _ready_indices(self, engines):
        """Readiness sweep (health layer on): the engine indices placement
        may use, with drain / undrain transitions journaled. Falls back to
        ALL indices when nothing is ready."""
        ready = []
        for i, eng in enumerate(engines):
            ok, reason = eng.ready()
            key = eng.health_name
            prev = self._ready_state.get(key)
            # journal each transition, including a first sweep that finds
            # the engine already unready
            if prev != ok and not (prev is None and ok):
                health.event("engine_undrain" if ok else "engine_drain",
                             engine=key, index=i, reason=reason)
                telemetry.counter(
                    "health.undrains" if ok else "health.drains").inc()
            self._ready_state[key] = ok
            if ok:
                ready.append(i)
        # forget replicas no longer in the fleet, or the dict grows with
        # every grow cycle's new engine names
        live = {e.health_name for e in engines}
        for key in [k for k in self._ready_state if k not in live]:
            del self._ready_state[key]
        telemetry.gauge("health.ready_engines").set(len(ready))
        if not ready:
            # availability over strictness: an all-unready fleet still
            # places by load (the engines' own backpressure bounds it)
            if not self._all_unready:
                self._all_unready = True
                health.event("fleet_all_unready", engines=len(engines))
            return list(range(len(engines)))
        self._all_unready = False
        return ready

    def submit(self, prompt, **kwargs):
        """Place one session: longest cached prompt prefix first, then
        least loaded (rotating tie-break; READY replicas only when the
        health layer is on and any is ready); fail over across replicas on
        `QueueFullError` or `ServerClosedError` and re-raise only when
        every candidate refuses. With QoS on, the class of the ``tenant``
        keyword orders the replicas between affinity and load: fewest live
        batch sessions first for interactive and standard work, most for
        batch work. Keyword arguments go to `GenerationEngine.submit`."""
        engines = self.engines
        n = len(engines)
        k = next(self._rr)
        candidates = (set(self._ready_indices(engines))
                      if health._enabled else None)
        matches = [e.prefix_match_len(prompt) for e in engines]
        best = max(matches)
        reg = qos.active()
        rank = reg.rank(kwargs.get("tenant")) if reg is not None else None

        def _key(i):
            j = (i + k) % n
            if rank is None:
                return (-matches[j], engines[j].load, i)
            b = engines[j].batch_live
            if rank < qos.BATCH_RANK:
                return (-matches[j], b, engines[j].load, i)
            return (-matches[j], engines[j].load, -b, i)

        last_exc = None
        for i in sorted(range(n), key=_key):
            j = (i + k) % n
            if candidates is not None and j not in candidates:
                continue
            eng = engines[j]
            try:
                stream = eng.submit(prompt, **kwargs)
            except (QueueFullError, ServerClosedError) as e:
                # a replica mid-drain (a concurrent scale_to shrink) fails
                # over like a full one
                last_exc = e
                continue
            if telemetry._enabled:
                telemetry.counter("serving.generation.routed").inc()
                telemetry.counter(
                    "serving.generation.routed_affinity"
                    if best > 0 and matches[j] == best
                    else "serving.generation.routed_load").inc()
            if health._enabled and best > 0 and matches[j] == best:
                health.event("router_affinity", engine=eng.health_name,
                             matched=int(matches[j]),
                             prompt_tokens=int(len(prompt)))
            return stream
        raise last_exc if last_exc is not None else QueueFullError(
            "every generation replica is saturated")

    def generate(self, prompt, **kwargs):
        """Blocking convenience: route, then collect the full token list."""
        return list(self.submit(prompt, **kwargs))

    def rebalance_parked(self, max_n=None):
        """Migrate parked (preempted) sessions to peer replicas: eject
        each source's park records (`GenerationEngine.eject_parked`) and
        `adopt` them on the least loaded OTHER replica, which re-prefills
        the session's whole context while its original stream keeps
        delivering, greedy-equal to a fresh submit of that context. A
        record no peer takes goes back to the source's own queue; only
        when that refuses too does the stream fail in band. Each engine's
        tick lock is taken in turn, never two at once (engines over one
        model tick under the model's lock). Returns the number of
        sessions moved to a peer."""
        engines = self.engines
        if len(engines) < 2:
            return 0
        migrated = 0
        for src in engines:
            if src.parked_count == 0:
                continue
            for rec in src.eject_parked(max_n):
                placed = None
                peers = sorted((e for e in engines if e is not src),
                               key=lambda e: e.load)
                for dst in peers:
                    if dst.adopt(rec):
                        placed = dst
                        migrated += 1
                        break
                if placed is None and not src.adopt(rec):
                    exc = QueueFullError(
                        "no replica could adopt the preempted session")
                    rec["stream"]._fail(exc)
                    if rec.get("span") is not None:
                        rec["span"].set(error=repr(exc),
                                        reason="migrate").finish()
                    continue
                if placed is not None:
                    if telemetry._enabled:
                        telemetry.counter(
                            "serving.generation.qos.migrated").inc()
                    if health._enabled:
                        health.event("qos_migrate",
                                     source=src.health_name,
                                     target=placed.health_name,
                                     tenant=rec.get("tenant") or "default",
                                     tokens=len(rec["tokens"]))
        return migrated

    def scale_to(self, n, reason="manual", warm=True):
        """Resize the fleet to ``n`` replicas (clamped to ``[min_engines,
        max_engines]``). Growth builds engines with the factory and warms
        them before they take traffic; shrink pops the newest replicas,
        stops placing on them at once and drains them in background
        threads (``close()``: live AND queued sessions finish). Returns the
        new fleet size; journaled as ``autoscale_actuate``. A closed
        router does not scale."""
        if self._closed:
            return len(self.engines)
        n = max(int(n), self._min)
        if self._max is not None:
            n = min(n, self._max)
        grown, drained = [], []
        with self._scale_lock:
            with self._lock:
                need = n - len(self._engines)
            if need > 0 and self._factory is None:
                raise MXNetError("GenerationRouter.scale_to needs an engine "
                                 "factory to grow the fleet")
            for _ in range(max(need, 0)):
                # built AND warmed before it is published: an unwarmed
                # replica sorts first by load, and a submit racing the
                # growth would pay its captures on the serving path
                eng = self._factory()
                if warm:
                    eng.warm()
                if self._ws_current is not None:
                    # the factory builds on the params the fleet started
                    # with; after a roll the fleet serves a newer version
                    eng.swap_weights(self._ws_current,
                                     version=self._ws_current.version)
                grown.append(eng)
            with self._lock:
                self._engines.extend(grown)
                while len(self._engines) > n:
                    drained.append(self._engines.pop())
        for eng in drained:
            t = threading.Thread(target=eng.close, daemon=True,
                                 name="mxnet_tpu_torch.serving.generation."
                                 "drain")
            t.start()
            with self._lock:
                self._draining.append((eng, t))
        if grown or drained:
            if telemetry._enabled:
                telemetry.gauge("serving.generation.replicas").set(n)
            if health._enabled:
                health.event("autoscale_actuate", replicas=n,
                             grown=len(grown), drained=len(drained),
                             reason=reason)
        with self._lock:
            self._draining = [(e, t) for e, t in self._draining
                              if t.is_alive()]
        return n

    def bind_autoscale(self):
        """Wire `health.on_autoscale` to `scale_to`: whenever the computed
        ``health.desired_engines`` changes, the fleet grows or drains (the
        callback runs on the SLO evaluation thread, so growth warms there,
        off every serving path). The hook holds the router weakly and goes
        inert once it closes or is collected (`on_autoscale` has no
        removal). Returns the callback."""
        wr = weakref.ref(self)

        def _actuate(desired, info):
            router = wr()
            if router is not None and not router._closed:
                router.scale_to(desired, reason="signal")

        return health.on_autoscale(_actuate)

    @staticmethod
    def _swap_burn():
        """The worst short-window SLO burn rate over the objectives, or
        None with the health layer off or no objective holding data: the
        rollout gate (a burn above 1 spends the error budget faster than
        the SLO allows)."""
        if not health._enabled:
            return None
        tracker = health.tracker()
        if tracker is None:
            return None
        report = tracker.evaluate()
        burns = [o.get("burn_short") for o in report.get("objectives", [])
                 if o.get("burn_short") is not None]
        return max(burns) if burns else None

    def _pin_baseline(self):
        """The first roll of this fleet: replica 0's live weights as the
        rollback target (the router was handed engines, not a WeightSet)."""
        from ..rollout import WeightSet

        engines = self.engines
        if not engines:
            return None
        version, params, draft = engines[0].weights_snapshot()
        return WeightSet(version, params, draft_params=draft,
                         source="fleet-baseline")

    def rolling_swap(self, weights, draft_params=None, version=None,
                     observe_s=None, gate=None, rollback=True,
                     reason="publish"):
        """Flip the fleet to new weights one replica at a time, gated on
        the SLO burn tracker.

        ``weights`` is a `rollout.WeightSet` or a plain name -> array dict.
        After each replica flips (`GenerationEngine.swap_weights`: between
        its ticks, nothing captured), the router waits ``observe_s``
        seconds (default ``MXNET_ROLLOUT_POLL_S``) and reads the worst
        short-window burn; a burn above ``gate`` (default
        ``MXNET_ROLLOUT_SLO_GATE``) stops the roll and, with
        ``rollback``, swaps every flipped replica back to the pinned
        previous version (``rollout_rollback`` event,
        ``rollout.rollbacks``). Runs under the scale lock, so a roll never
        interleaves with a grow or a drain. Returns a report dict."""
        if self._closed:
            raise MXNetError("rolling_swap on a closed router")
        from ..rollout import WeightSet

        if gate is None:
            gate = float(getenv("MXNET_ROLLOUT_SLO_GATE"))
        if observe_s is None:
            observe_s = float(getenv("MXNET_ROLLOUT_POLL_S"))
        with self._scale_lock:
            if self._ws_current is None:
                self._ws_current = self._pin_baseline()
            if isinstance(weights, WeightSet):
                target = weights
                if version is None:
                    version = target.version
            else:
                if version is None:
                    version = (self._ws_current.version
                               if self._ws_current is not None else 0) + 1
                target = WeightSet(version, dict(weights),
                                   draft_params=draft_params, source=reason)
            previous = self._ws_current
            engines = self.engines
            report = {"version": int(version), "replicas": len(engines),
                      "swapped": 0, "noops": 0, "rolled_back": False,
                      "burn": None,
                      "previous_version": (previous.version
                                           if previous is not None else None)}
            flipped = []
            breach = None
            for i, eng in enumerate(engines):
                v = eng.swap_weights(target, draft_params=draft_params,
                                     version=version)
                if v is None:
                    report["noops"] += 1
                    continue
                flipped.append(eng)
                report["swapped"] += 1
                if health._enabled:
                    health.event("rollout_roll", engine=eng.health_name,
                                 index=i, version=int(version),
                                 replicas=len(engines))
                if observe_s > 0:
                    time.sleep(observe_s)
                burn = self._swap_burn()
                if burn is not None:
                    report["burn"] = float(burn)
                    if burn > gate:
                        breach = float(burn)
                        break
            if breach is not None and rollback and previous is not None:
                # the same in-place swap, so the rollback captures nothing
                for eng in flipped:
                    eng.swap_weights(previous, version=previous.version)
                report["rolled_back"] = True
                telemetry.counter("rollout.rollbacks").inc()
                if health._enabled:
                    health.event("rollout_rollback", version=int(version),
                                 restored=int(previous.version),
                                 burn=breach, gate=float(gate),
                                 replicas_hit=len(flipped))
                # _ws_current stays `previous`: a rollback of a rollback
                # converges on the same pinned version
                return report
            if report["swapped"]:
                if (self._ws_previous is not None
                        and self._ws_previous is not previous):
                    self._ws_previous.release()
                self._ws_previous = previous
                self._ws_current = target.acquire()
                telemetry.counter("rollout.rolls").inc()
                telemetry.gauge("rollout.fleet_version").set(int(version))
            return report

    def warm(self, buckets=None):
        """Warm every replica; sums the builds (``serving.warmup``
        reports through this)."""
        out = {"buckets": None, "compiles": 0, "captures": 0,
               "seconds": 0.0, "cache_entries": 0}
        for e in self.engines:
            w = e.warm(buckets)
            out["buckets"] = w["buckets"]
            for key in ("compiles", "captures", "seconds", "cache_entries"):
                out[key] += w[key]
        return out

    def close(self, timeout=None):
        self._closed = True
        for e in self.engines:
            e.close(timeout)
        with self._lock:
            draining, self._draining = self._draining, []
        for _, t in draining:
            t.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def stats(self):
        engines = self.engines
        return {"replicas": len(engines),
                "loads": [e.load for e in engines],
                "engines": [e.stats() for e in engines]}
