"""Weight rollout: versioned train -> serve checkpoint streaming over a
watched directory. The port of `mxnet_tpu/serving/rollout.py`.

* **publish** (:func:`publish`, hooked into `model.save_checkpoint` through
  :func:`publish_checkpoint` when ``MXNET_ROLLOUT_DIR`` is set): one
  CRC-footed payload file per version (`nd.save`: every array carries a
  crc32/length footer) holding ``arg:``/``aux:``/``draft:`` entries as
  host arrays, then a version-tagged JSON manifest written
  temp-then-`durable_replace`, so a reader sees the old manifest set or
  the new one, never a torn file. A re-publish of an existing version is a
  no-op. Files of either package load in the other.
* **subscribe** (:class:`RolloutSubscriber` / :class:`RolloutWatcher`):
  poll the directory, ingest the newest unseen version into a
  refcounted :class:`WeightSet` (CRC-verified by `nd.load`), and REJECT
  and keep serving on a torn manifest, a corrupt payload or a
  stale/duplicate version stamp; each rejection is journaled
  (``rollout_reject``). All three are fault-injectable through the
  ``publish`` point of ``MXNET_FAULT_SPEC``.
* **swap**: `Predictor.swap_weights` flips to a WeightSet between batch
  flushes by writing the new values into the tensors its graphs read:
  identical shapes, nothing captured again.

With telemetry on: ``rollout.publishes``, ``publish_us``,
``publish_duplicate``, ``publish_errors``, ``ingests``, ``rejects`` (and
``reject_<reason>``), ``apply_errors`` and the version gauges.
`GenerationEngine.swap_weights` takes a WeightSet too, and
`GenerationRouter.rolling_swap` rolls one through a fleet of engines a
replica at a time behind the SLO burn gate (``MXNET_ROLLOUT_SLO_GATE``).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

import numpy as np

from .. import health, telemetry
from .. import ndarray as nd
from ..base import MXNetError, getenv, register_env
from ..log import get_logger
from ..resilience import CorruptCheckpointError, durable_replace, inject

__all__ = ["WeightSet", "RolloutSubscriber", "RolloutWatcher",
           "RolloutError", "publish", "publish_checkpoint",
           "list_versions"]

register_env("MXNET_ROLLOUT_DIR", "",
             "weight-rollout directory: save_checkpoint publishes each "
             "epoch there as a versioned WeightSet (CRC-footed payload + "
             "atomic manifest) and serving subscribers hot-swap to it; "
             "empty disables the train->serve publisher hook")
register_env("MXNET_ROLLOUT_POLL_S", 2.0,
             "seconds between rollout-directory polls of a "
             "RolloutWatcher subscriber thread")
register_env("MXNET_ROLLOUT_SLO_GATE", 1.0,
             "rolling_swap burn gate: after each replica flips, a short-"
             "window SLO burn rate above this triggers automatic "
             "journaled rollback of the whole fleet to the pinned "
             "previous version")
register_env("MXNET_ROLLOUT_KEEP", 4,
             "retain only the newest K published versions in the rollout "
             "directory (payload + manifest pairs; 0 = keep all)")

_PAYLOAD_FMT = "v%06d.params"
_MANIFEST_FMT = "v%06d.manifest.json"
_MANIFEST_RE = re.compile(r"^v(\d{6,})\.manifest\.json$")


def _cpu():
    from ..context import cpu

    return cpu()


def _logger():
    return get_logger("mxnet_tpu_torch.serving.rollout")


class RolloutError(MXNetError):
    """A publish could not complete (IO fault, bad version)."""


def _host(v):
    """One parameter as a host array: ``asnumpy`` for NDArrays (a copy),
    ``np.asarray`` otherwise."""
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


class WeightSet:
    """One published weight version: host copies of the arg / aux (and
    optional speculative-draft) parameters, refcounted so a version stays
    pinned while any serving stack still reads it."""

    def __init__(self, version, arg_params, aux_params=None,
                 draft_params=None, source=""):
        self.version = int(version)
        self.arg_params = {str(k): _host(v)
                           for k, v in dict(arg_params or {}).items()}
        self.aux_params = {str(k): _host(v)
                           for k, v in dict(aux_params or {}).items()}
        self.draft_params = {str(k): _host(v)
                             for k, v in dict(draft_params or {}).items()}
        self.source = source
        self._refs = 1                # creator's reference
        self._lock = threading.Lock()

    @property
    def refs(self):
        with self._lock:
            return self._refs

    def acquire(self):
        with self._lock:
            self._refs += 1
        return self

    def release(self):
        """Drop one reference; returns True when the set just became
        unreferenced (fully drained everywhere)."""
        with self._lock:
            self._refs = max(self._refs - 1, 0)
            return self._refs == 0

    def nbytes(self):
        return sum(a.nbytes for params in
                   (self.arg_params, self.aux_params, self.draft_params)
                   for a in params.values())

    def __repr__(self):
        return (f"WeightSet(version={self.version}, "
                f"arrays={len(self.arg_params) + len(self.aux_params) + len(self.draft_params)}, "
                f"refs={self.refs})")


# ---------------------------------------------------------------------------
# Publish
# ---------------------------------------------------------------------------


def list_versions(rollout_dir):
    """Sorted version numbers with a manifest file in ``rollout_dir``
    (filename-level: a fault-stamped stale manifest still counts as its
    filename's version here — content validation is the subscriber's)."""
    try:
        names = os.listdir(str(rollout_dir))
    except OSError:
        return []
    return sorted(int(m.group(1))
                  for m in map(_MANIFEST_RE.match, names) if m)


def publish(rollout_dir, version, arg_params, aux_params=None,
            draft_params=None, source=""):
    """Atomically publish one weight version into ``rollout_dir``: every
    parameter as a host array in the CRC-footed payload (`nd.save`, done
    before the manifest, so the manifest never points at an unfinished
    file), then the JSON manifest temp-then-rename. Returns the manifest path, or None when
    ``version`` is already published (idempotent double-publish no-op).

    The ``publish`` fault point of ``MXNET_FAULT_SPEC`` covers the whole
    operation: errno rules raise here; ``truncate=K`` tears the manifest
    at K bytes (torn rename); ``error=CORRUPT`` flips a payload byte
    after the CRC footers are written; ``error=STALE`` stamps the
    manifest with an already-published version number — the three
    publish pathologies the subscriber must reject."""
    rollout_dir = str(rollout_dir)
    version = int(version)
    if version < 0:
        raise RolloutError(f"rollout version must be >= 0, got {version}")
    t0 = time.perf_counter()
    os.makedirs(rollout_dir, exist_ok=True)
    manifest_path = os.path.join(rollout_dir, _MANIFEST_FMT % version)
    if os.path.exists(manifest_path):
        if telemetry._enabled:
            telemetry.counter("rollout.publish_duplicate").inc()
        _logger().info("rollout: version %d already published, no-op",
                       version)
        return None
    # the fault hook may raise (errno rules) or hand back a rule whose
    # CORRUPT/STALE/truncate payload this writer enacts on itself
    rule = inject("publish", manifest_path)
    mode = getattr(rule, "error", None) if rule is not None else None
    torn = getattr(rule, "truncate", None) if rule is not None else None

    save_dict = {}
    for prefix, params in (("arg", arg_params), ("aux", aux_params),
                           ("draft", draft_params)):
        for k, v in dict(params or {}).items():
            save_dict[f"{prefix}:{k}"] = nd.array(_host(v), ctx=_cpu())
    if not save_dict:
        raise RolloutError("publish needs at least one parameter")
    payload = _PAYLOAD_FMT % version
    payload_path = os.path.join(rollout_dir, payload)
    nd.save(payload_path, save_dict)
    if mode == "CORRUPT":
        with open(payload_path, "r+b") as f:
            off = max(os.path.getsize(payload_path) // 2, 32)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([(b[0] if b else 0) ^ 0xFF]))
        _logger().warning("fault injection: corrupted payload byte of %s",
                          payload_path)
    stamped = version
    if mode == "STALE":
        prior = [v for v in list_versions(rollout_dir) if v < version]
        stamped = prior[-1] if prior else version
        _logger().warning("fault injection: stamping manifest %s with "
                          "stale version %d", manifest_path, stamped)
    doc = json.dumps({"version": stamped, "payload": payload,
                      "arrays": len(save_dict), "source": str(source),
                      "created_unix": time.time()}, indent=0)
    if torn is not None:
        doc = doc[:torn]
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(doc)
        f.flush()
        os.fsync(f.fileno())
    durable_replace(tmp, manifest_path)
    _retain(rollout_dir)
    if telemetry._enabled:
        telemetry.counter("rollout.publishes").inc()
        telemetry.gauge("rollout.published_version").set(version)
        telemetry.histogram("rollout.publish_us").record(
            (time.perf_counter() - t0) * 1e6)
    if health._enabled:
        health.event("rollout_publish", version=version,
                     arrays=len(save_dict), source=str(source))
    _logger().info("rollout: published version %d (%d arrays) to %s",
                   version, len(save_dict), rollout_dir)
    return manifest_path


def _retain(rollout_dir, keep=None):
    """Drop all but the newest ``keep`` published versions (manifest +
    payload pairs); 0 keeps everything — same retention contract as
    ``MXNET_CHECKPOINT_KEEP``."""
    keep = int(getenv("MXNET_ROLLOUT_KEEP") if keep is None else keep)
    if keep <= 0:
        return
    for v in list_versions(rollout_dir)[:-keep]:
        for name in (_MANIFEST_FMT % v, _PAYLOAD_FMT % v):
            try:
                os.remove(os.path.join(rollout_dir, name))
            except OSError:
                pass


def publish_checkpoint(prefix, epoch, arg_params, aux_params=None,
                       rollout_dir=None):
    """The ``save_checkpoint`` publisher hook: publish epoch ``epoch`` as
    rollout version ``epoch`` when ``MXNET_ROLLOUT_DIR`` is set (no-op
    otherwise). Publish failures are logged and counted but NEVER
    raised — a sick serving directory must not kill the training loop
    that is trying to checkpoint."""
    rollout_dir = (getenv("MXNET_ROLLOUT_DIR") if rollout_dir is None
                   else rollout_dir)
    if not str(rollout_dir or "").strip():
        return None
    try:
        return publish(rollout_dir, epoch, arg_params, aux_params,
                       source=f"{prefix}@{int(epoch)}")
    except Exception as e:  # noqa: BLE001 — training survives publish faults
        if telemetry._enabled:
            telemetry.counter("rollout.publish_errors").inc()
        if health._enabled:
            health.event("rollout_publish_error", version=int(epoch),
                         error=repr(e))
        _logger().error("rollout: publish of epoch %s failed (training "
                        "continues): %r", epoch, e)
        return None


# ---------------------------------------------------------------------------
# Subscribe
# ---------------------------------------------------------------------------


def _load_weightset(payload_path, version):
    """CRC-verified ingest of one payload file into a WeightSet (the footer
    walk inside `nd.load` raises `CorruptCheckpointError` on any flipped
    byte)."""
    arg, aux, draft = {}, {}, {}
    for k, v in nd.load(payload_path, ctx=_cpu()).items():
        kind, _, name = k.partition(":")
        {"arg": arg, "aux": aux, "draft": draft}.get(kind, arg)[name] = v
    return WeightSet(version, arg, aux, draft, source=payload_path)


class RolloutSubscriber:
    """Poll-driven ingest side of the rollout directory: ``poll()``
    returns a freshly ingested :class:`WeightSet` (the NEWEST unseen
    valid version) or None. Every invalid manifest is rejected exactly
    once — torn JSON, stale/duplicate version stamp, corrupt-CRC
    payload — with the subscriber (and whatever it feeds) continuing to
    serve the current version; that reject-and-keep-serving path is what
    the ``publish`` fault rules exercise."""

    def __init__(self, rollout_dir, current_version=0):
        self._dir = str(rollout_dir)
        self.version = int(current_version)
        self._handled = set()         # manifest filenames ingested/rejected

    def _reject(self, name, reason, exc=None, version=None):
        self._handled.add(name)
        if telemetry._enabled:
            telemetry.counter("rollout.rejects").inc()
            telemetry.counter(f"rollout.reject_{reason}").inc()
        if health._enabled:
            health.event("rollout_reject", manifest=name, reason=reason,
                         version=version, serving=self.version,
                         **({"error": repr(exc)} if exc is not None else {}))
        _logger().warning(
            "rollout: rejected %s (%s%s); still serving version %d",
            name, reason, f": {exc!r}" if exc is not None else "",
            self.version)

    def poll(self):
        """One directory sweep. Returns the ingested WeightSet for the
        newest unseen valid version, or None (nothing new, or everything
        new was rejected)."""
        try:
            names = sorted(os.listdir(self._dir))
        except OSError:
            return None
        fresh = []
        for name in names:
            m = _MANIFEST_RE.match(name)
            if m is None or name in self._handled:
                continue
            path = os.path.join(self._dir, name)
            try:
                with open(path) as f:
                    doc = json.load(f)
                version = int(doc["version"])
                payload = str(doc["payload"])
            except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
                self._reject(name, "torn_manifest", e)
                continue
            if version <= self.version:
                # a NEW manifest file stamping an old (or the current)
                # version — the stale/duplicate publish pathology
                self._reject(name, "stale_version", version=version)
                continue
            fresh.append((version, name, payload))
        for version, name, payload in sorted(fresh, reverse=True):
            try:
                ws = _load_weightset(os.path.join(self._dir, payload),
                                     version)
            except (MXNetError, OSError) as e:
                reason = ("corrupt_crc"
                          if isinstance(e, CorruptCheckpointError)
                          else "unreadable_payload")
                self._reject(name, reason, e, version=version)
                continue
            self._handled.add(name)
            # versions skipped over by this ingest are handled silently —
            # they were valid, just superseded within one poll window
            for v, n, _ in fresh:
                if v < version:
                    self._handled.add(n)
            self.version = version
            if telemetry._enabled:
                telemetry.counter("rollout.ingests").inc()
                telemetry.gauge("rollout.version").set(version)
            if health._enabled:
                health.event("rollout_ingest", version=version,
                             manifest=name)
            _logger().info("rollout: ingested version %d from %s",
                           version, name)
            return ws
        return None


class RolloutWatcher:
    """Background subscriber thread: polls every ``MXNET_ROLLOUT_POLL_S``
    and hands each ingested WeightSet to ``apply`` (e.g. a predictor's
    ``swap_weights``). Apply failures are
    logged and the watcher keeps polling — the serving side never dies
    because a publish was bad."""

    def __init__(self, rollout_dir, apply, poll_s=None, current_version=0,
                 start=True):
        self._apply = apply
        self._poll_s = float(getenv("MXNET_ROLLOUT_POLL_S")
                             if poll_s is None else poll_s)
        self.subscriber = RolloutSubscriber(rollout_dir, current_version)
        self._stop = threading.Event()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="mxnet_tpu_torch.serving.rollout.watch")
            self._thread.start()

    def poll_once(self):
        """One manual poll+apply step (tests, start=False watchers)."""
        ws = self.subscriber.poll()
        if ws is None:
            return None
        try:
            self._apply(ws)
        except Exception as e:  # noqa: BLE001 — keep serving, keep polling
            if telemetry._enabled:
                telemetry.counter("rollout.apply_errors").inc()
            _logger().error("rollout: applying version %d failed: %r",
                            ws.version, e)
        return ws

    def _loop(self):
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self._poll_s)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
