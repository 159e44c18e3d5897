"""Fleet health: liveness and readiness probes and the event journal.

The port of the probe registry of `mxnet_tpu/health.py` (`:129-323`,
`:771-846`):

* **liveness / readiness registries**: per-object probes
  (:func:`register_liveness` / :func:`register_readiness`, weakly held)
  aggregated by :func:`liveness` / :func:`readiness`. The serving layer
  registers every `Predictor` and `DynamicBatcher` (`serving/health.py`);
* **event journal**: a bounded ring of structured runtime events
  (rollout publishes, rejects and swaps).

Everything gates on the module-level ``_enabled`` flag (``MXNET_HEALTH=1``
or :func:`enable`): call sites read one attribute when it is off, and the
probes are not consulted. Not ported yet (ROADMAP.md queue A, item 9):
the progress beacons, the stall watchdog that reads them and its
diagnostic bundles, the SLO tracker (so
readiness does not include the error budget) and the autoscale signal.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref

from .base import getenv, register_env

__all__ = ["enabled", "enable", "disable", "reset", "event", "events",
           "register_liveness", "register_readiness", "unregister",
           "liveness", "readiness"]

register_env("MXNET_HEALTH", False,
             "enable the fleet-health layer: liveness/readiness probes "
             "and the event journal")
register_env("MXNET_HEALTH_EVENTS", 512,
             "event-journal ring capacity (oldest events drop off)")
register_env("MXNET_HEALTH_QUEUE_WATERMARK", 0.8,
             "readiness watermark: a serving intake queue above this "
             "fraction of MXNET_SERVING_MAX_QUEUE reports not-ready")

# THE gate: call sites read `health._enabled` before any other health work
_enabled = bool(getenv("MXNET_HEALTH"))

_lock = threading.Lock()


def enabled():
    return _enabled


def enable(on=True):
    """Turn the health layer on (also: ``MXNET_HEALTH=1`` at import)."""
    global _enabled
    _enabled = bool(on)


def disable():
    enable(False)


def reset():
    """Drop the journal and the probes (tests). The enabled flag is
    kept."""
    with _lock:
        _journal.clear()
        _liveness.clear()
        _readiness.clear()


# ---------------------------------------------------------------------------
# Event journal
# ---------------------------------------------------------------------------

_journal = collections.deque(maxlen=int(getenv("MXNET_HEALTH_EVENTS")))


def event(kind, **detail):
    """Append one structured event to the bounded journal (a no-op when the
    layer is off: call sites gate on ``health._enabled`` first)."""
    if not _enabled:
        return None
    ev = {"ts": time.time(), "kind": str(kind)}
    ev.update(detail)
    with _lock:
        _journal.append(ev)
    return ev


def events(n=None, kind=None):
    """The journal, oldest first (``n`` caps it to the newest n; ``kind``
    filters)."""
    with _lock:
        out = list(_journal)
    if kind is not None:
        out = [e for e in out if e["kind"] == kind]
    if n is not None:
        out = out[-int(n):]
    return out


# ---------------------------------------------------------------------------
# Liveness / readiness registries
# ---------------------------------------------------------------------------

# name -> (weakref(owner), probe). probe(owner) returns (ok, detail) or a
# plain bool. Dead owners drop out at read time.
_liveness = {}
_readiness = {}


def register_liveness(name, owner, probe):
    with _lock:
        _liveness[name] = (weakref.ref(owner), probe)


def register_readiness(name, owner, probe):
    with _lock:
        _readiness[name] = (weakref.ref(owner), probe)


def unregister(name):
    """Remove ``name`` from both registries (a deliberately closed server
    must not pin readiness false forever)."""
    with _lock:
        _liveness.pop(name, None)
        _readiness.pop(name, None)


def _run_probes(registry):
    with _lock:
        items = list(registry.items())
    ok_all = True
    out = {}
    for name, (ref, probe) in items:
        owner = ref()
        if owner is None:
            with _lock:
                if registry.get(name) == (ref, probe):
                    del registry[name]
            continue
        try:
            r = probe(owner)
        except Exception as e:  # noqa: BLE001 — a probe bug is "not ok"
            r = (False, f"probe error: {e!r}")
        ok, detail = r if isinstance(r, tuple) else (bool(r), "")
        out[name] = {"ok": bool(ok), "detail": detail}
        ok_all = ok_all and bool(ok)
    return ok_all, out


def liveness():
    """(ok, {probe: {ok, detail}}) over every liveness probe (worker
    threads alive). Trivially alive when the layer is off."""
    if not _enabled:
        return True, {}
    return _run_probes(_liveness)


def readiness():
    """(ok, {probe: {ok, detail}}) over every readiness probe (warm-up
    done, queue below its watermark). Trivially ready when the layer is
    off."""
    if not _enabled:
        return True, {}
    return _run_probes(_readiness)
